// Fast CSV matrix loader.
//
// Native counterpart of the reference's raceline reader
// (util/read_raceline_csv.m: MATLAB readmatrix + column unpack).  Batched
// scenario sweeps can load thousands of perturbed raceline files; this
// loader memory-maps nothing fancy but parses with strtod in one pass.
// C ABI for ctypes.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parses a numeric CSV (optionally with a single header line).  Returns a
// malloc'd row-major array in *data with *rows x *cols; caller frees with
// csv_free.  Returns 0 on success.
int csv_read_matrix(const char* path, double** data, int* rows, int* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return 1;
  }
  std::fclose(f);
  buf[size] = '\0';

  std::vector<double> values;
  values.reserve(4096);
  int ncols = -1;
  int nrows = 0;

  char* p = buf.data();
  char* end = buf.data() + size;
  while (p < end) {
    // one line
    char* line_end = static_cast<char*>(std::memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    *line_end = '\0';

    int count = 0;
    bool numeric = true;
    char* q = p;
    std::vector<double> row;
    while (*q) {
      char* next = nullptr;
      double v = std::strtod(q, &next);
      if (next == q) {  // not a number (header line)
        numeric = false;
        break;
      }
      row.push_back(v);
      ++count;
      q = next;
      while (*q == ',' || *q == ' ' || *q == '\t' || *q == '\r') ++q;
    }
    if (numeric && count > 0) {
      if (ncols < 0) ncols = count;
      if (count == ncols) {
        values.insert(values.end(), row.begin(), row.end());
        ++nrows;
      }
    }
    p = line_end + 1;
  }

  if (nrows == 0 || ncols <= 0) return 2;
  double* out = static_cast<double*>(std::malloc(values.size() * sizeof(double)));
  if (!out) return 3;
  std::memcpy(out, values.data(), values.size() * sizeof(double));
  *data = out;
  *rows = nrows;
  *cols = ncols;
  return 0;
}

void csv_free(double* data) { std::free(data); }

}  // extern "C"
