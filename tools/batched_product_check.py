#!/usr/bin/env python3
"""Whether a batched product's result for one matrix depends on where the
matrix sits in the batch, on one card.

    python3 tools/batched_product_check.py

The Riccati IPM's matrix-vector products over the stages of a batch
(``einsum("bnri,bni->bnr")`` and the like, at B = 12,288, N = 40: 491,520
matrices) are computed for the whole batch and again shard by shard
(``torch.tensor_split`` into 3 and 12 shards, as ``chip_smoke.py``
phase 8 splits the pod batch), on seeded random f32 data of the IPM's
shapes.  Prints, per form and split, how many instances differ at all,
their runs of indices and the largest difference.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def runs(mask):
    """The runs (first, last) of consecutive True indices."""
    idx = [i for i, v in enumerate(mask) if v]
    out = []
    for i in idx:
        if out and i == out[-1][1] + 1:
            out[-1][1] = i
        else:
            out.append([i, i])
    return [tuple(r) for r in out]


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    print("card:", cs.card_line(), "; torch", torch.__version__, "cuda",
          torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(cs.SEED)
    B, N, r, nx = 12288, cs.N_MAIN, cs.R, cs.NX
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    C, x, z, Ad = rnd(B, N, r, nx), rnd(B, N, nx), rnd(B, N, r), \
        rnd(B, N, nx, nx)
    forms = {"bnri,bni->bnr": (C, x), "bnri,bnr->bni": (C, z),
             "bnij,bnj->bni": (Ad, x)}
    for shards in (3, 12):
        for form, (a, b) in forms.items():
            whole = torch.einsum(form, a, b)
            parts = torch.cat([torch.einsum(form, p, q) for p, q in zip(
                torch.tensor_split(a, shards), torch.tensor_split(b, shards))])
            ne = (whole != parts).reshape(B, -1).any(1).cpu().tolist()
            print(f"{shards} shards, einsum {form}: instances differing "
                  f"{sum(ne)} of {B}, runs {runs(ne)[:8]}, max |d| "
                  f"{float((whole - parts).abs().max()):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
