// cp.async is declared in cuda_runtime.h of this emulation.
