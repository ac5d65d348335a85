#!/usr/bin/env python3
"""The flash-attention forward (``fedml_tpu_torch/csrc/flash_attention.cu``)
against other builds of it, in turns, on one NVIDIA card.

Run from the root of a checkout:

    python3 profile_flash.py --other NAME=PATH [--other NAME=PATH ...]

Each ``--other`` is a source with the same C interface, such as an earlier
commit's ``flash_attention.cu``; it is built with ``ops/cuda_build``'s
flags and bound as the port binds the checkout's own build ("new").  At
``chip_smoke.py`` phase 4's shapes (the BERT-tiny eval pass ``[32·2, 80,
64]`` and ``[8·2, 512, 64]`` in bfloat16, the fed-LLM eval pass ``[4·2,
32, 64]`` in float32) and in float32 at phase 5's transformer training
batch ``[8·2, 80, 64]`` and at ``[8·2, 512, 64]``, all causal, on the
model's ``[B, T, H, D]`` views, it reads each build's max |o − plain o|,
in bfloat16 the share of o's values that round otherwise than the plain
version's, and whether o, l and m equal the checkout's build's bit for
bit; then it times the builds in turns (new, others, others reversed, new), through the
port's wrapper with the build swapped in, cold L2, the host hidden behind
a GPU sleep, median of 50, beside ``scaled_dot_product_attention`` in the
same dtype and the bound as ``chip_smoke.py`` phase 4 counts it.  It prints the card's name and power limit, one line per
shape, and last one JSON object of all of it.  It needs one CUDA card
and ``nvcc``; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json

import torch

import chip_smoke
from fedml_tpu_torch.ops import cuda_build
from fedml_tpu_torch.ops import pallas_attention as attn

#: phase 5's transformer training batch: batch 8, 2 heads, 80 tokens
LM_TRAIN_SHAPE = (8, 2, 80, 64)
SHAPES = ((chip_smoke.LM_EVAL_SHAPE, torch.bfloat16),
          (chip_smoke.LM_LONG_SHAPE, torch.bfloat16),
          (chip_smoke.LLM_EVAL_SHAPE, torch.float32),
          (LM_TRAIN_SHAPE, torch.float32),
          (chip_smoke.LM_LONG_SHAPE, torch.float32))
FNS = ("fedml_flash_attention", "fedml_cuda_error_string")


def accuracy(q, k, v):
    """max |o − plain o|, in bfloat16 the share of o's values that differ
    from the plain version's, and (o, l, m) themselves."""
    out = attn.flash_attention_residuals(q, k, v, True)
    o, ref = out[0], attn._reference_residuals(q, k, v, True)[0]
    err = float((o.float() - ref.float()).abs().max())
    return err, (chip_smoke._bf16_flips(o, ref)
                 if o.dtype == torch.bfloat16 else None), out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", required=True,
                    metavar="NAME=PATH",
                    help="another flash_attention.cu to time, by name")
    args = ap.parse_args()
    card, smi = chip_smoke.device_phase()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    libs = {"new": attn._kernel_lib()}
    for spec in args.other:
        name, path = spec.split("=", 1)
        libs[name] = cuda_build.load_variant(
            f"flash_{name}", path, libs["new"], FNS)
    order = list(libs) + list(reversed(libs))

    from torch.nn.functional import scaled_dot_product_attention

    gen = torch.Generator().manual_seed(4)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    result = {"card": smi, "order": order, "shapes": []}
    # the card's clocks up before the first timed call
    q, k, v = chip_smoke._flash_qkv(*chip_smoke.LM_EVAL_SHAPE, torch.bfloat16,
                                    gen, dev)
    for lib in libs.values():
        attn._libs["flash_attention"] = lib
        chip_smoke._time_ms(
            lambda: attn.flash_attention_residuals(q, k, v, True), flush)
    for shape, dtype in SHAPES:
        q, k, v = chip_smoke._flash_qkv(*shape, dtype, gen, dev)
        acc = {}
        for n, lib in libs.items():
            attn._libs["flash_attention"] = lib
            acc[n] = accuracy(q, k, v)
        times = {n: [] for n in libs}
        for i, n in enumerate(order):
            attn._libs["flash_attention"] = libs[n]
            times[n].append(chip_smoke._time_ms(
                lambda: attn.flash_attention_residuals(q, k, v, True), flush,
                hide=True))
            if i == len(libs) - 1:
                sdpa_ms = chip_smoke._time_ms(
                    lambda: scaled_dot_product_attention(q, k, v,
                                                         is_causal=True),
                    flush, hide=True)
        same = {n: all(torch.equal(x.contiguous().view(torch.uint8),
                                   y.contiguous().view(torch.uint8))
                       for x, y in zip(a[2], acc["new"][2]))
                for n, a in acc.items() if n != "new"}
        b, h, t, d = shape
        bound_ms, bound_by = chip_smoke._bound(
            4 * b * h * t * d * q.element_size() + 2 * b * h * t * 4,
            2 * b * h * d * t * (t + 1), card,
            peak="bf16" if dtype == torch.bfloat16 else "f32")
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "ms": times, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "max_abs_err": {n: a[0] for n, a in acc.items()},
               "o_flips": {n: a[1] for n, a in acc.items()},
               "same_bits_as_new": same}
        result["shapes"].append(row)
        flips = ("" if dtype != torch.bfloat16 else
                 "; o values rounded otherwise than the plain version's "
                 + ", ".join(f"{n} {a[1]:.4%}" for n, a in acc.items()))
        print(f"flash_attention at {list(shape)} {row['dtype']} causal, cold "
              f"L2, median of 50, in the order {' '.join(order)}: "
              + ", ".join(f"{n} {' / '.join(f'{x:.4f}' for x in ts)} ms"
                          for n, ts in times.items())
              + f"; scaled_dot_product_attention {sdpa_ms:.4f} ms; bound "
              f"{bound_ms:.5f} ms ({bound_by}); max |err| "
              + ", ".join(f"{n} {a[0]:.2e}" for n, a in acc.items()) + flips
              + "; o, l and m bit for bit as new's: "
              + ", ".join(f"{n} {'yes' if x else 'no'}"
                          for n, x in same.items()),
              flush=True)
    attn._libs.pop("flash_attention", None)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
