#!/usr/bin/env python3
"""The multi-client conv's bfloat16 kernels (``fedml_tpu_torch/csrc/
mc_conv.cu``: the forward and the weight gradient) against other builds of
them, in turns, on one NVIDIA card.

Run from the root of a checkout:

    python3 profile_mc_conv.py --other NAME=PATH [--other NAME=PATH ...]

Each ``--other`` is a source with the same C interface, such as an earlier
commit's ``mc_conv.cu``; it is built with ``ops/cuda_build``'s flags and
bound as the port binds the checkout's own build ("new").  At ResNet-56's
eight conv shapes (``chip_smoke.RESNET56_CONVS``), K 10 clients of batch
32 in bfloat16, it reads each build's max |err| against the plain versions
(and whether it lies within ``chip_smoke._sum_err``'s tolerance), then
times the builds in turns (new, others, others reversed, new) through the
port's wrappers with the build swapped in, cold L2, the host hidden behind
a GPU sleep, median of 50, beside the grouped library call
(``F.conv2d(groups=10)``, ``torch.nn.grad.conv2d_weight(groups=10)``) on
operands laid out outside the timed call, and each shape's bound
(``chip_smoke.mc_work``).  Last come the sums over one ResNet-56 pass
(each shape's median times its count of convs).  It prints the card's
name and power limit, one line per shape and kind, and last one JSON
object of all of it.  It needs one CUDA card and ``nvcc``; without a card
it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics

import torch
import torch.nn.functional as F

import chip_smoke
from fedml_tpu_torch.ops import cuda_build
from fedml_tpu_torch.ops import pallas_mc_conv as mcc

FNS = ("fedml_mc_conv_fwd", "fedml_mc_conv_wgrad_splits",
       "fedml_mc_conv_wgrad", "fedml_cuda_error_string")


def accuracy(x, w, g, k, stride):
    """(max |err| of y, max |err| of dw, both within the tolerance) against
    the plain versions: √terms · 2^-23 · Σ|terms|, plus one bfloat16 step
    of y."""
    out = []
    y = mcc.mc_conv_fwd(x, w, stride)
    dw = mcc.mc_conv_wgrad(x, g, k, k, stride)
    torch.cuda.synchronize()
    ci = x.shape[-1]
    m = g.numel() // (g.shape[0] * g.shape[-1])
    for got, ref, terms, n in (
            (y, mcc.mc_conv_fwd_reference(x, w, stride),
             mcc.mc_conv_fwd_reference(x.abs(), w.abs(), stride),
             k * k * ci),
            (dw, mcc.mc_conv_wgrad_reference(x, g, k, k, stride),
             mcc.mc_conv_wgrad_reference(x.abs(), g.abs(), k, k, stride),
             m)):
        diff = (got.float() - ref.float()).abs()
        tol = math.sqrt(n) * 2.0 ** -23 * terms.float()
        if got.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * ref.float().abs()
        out.append((float(diff.max()), bool((diff <= tol).all())
                    and bool(torch.isfinite(got.float()).all())))
    same = torch.equal(dw, mcc.mc_conv_wgrad(x, g, k, k, stride))
    return out[0][0], out[1][0], out[0][1] and out[1][1] and same


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another mc_conv.cu to time, by name")
    args = ap.parse_args()
    card, smi = chip_smoke.device_phase()
    dev = torch.device("cuda", 0)

    libs = {"new": mcc._kernel_lib()}
    for spec in args.other:
        name, path = spec.split("=", 1)
        libs[name] = cuda_build.load_variant(
            f"mc_conv_{name}", path, libs["new"], FNS)
    others = list(libs)[1:]
    order = ["new"] + others + others[::-1] + ["new"]
    peak = chip_smoke.card_peaks(card)[2]

    gen = torch.Generator().manual_seed(12)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    result = {"card": smi, "order": order, "shapes": []}
    # the card's clocks up before the first timed call
    x, w, g = chip_smoke._mc_tensors(chip_smoke._mc_shape_case(8, 64, 64, 3,
                                                               1),
                                     torch.bfloat16, gen, dev)
    for lib in libs.values():
        mcc._libs["mc_conv"] = lib
        chip_smoke._time_ms(lambda: mcc.mc_conv_fwd(x, w), flush)
    sums = {kind: {n: 0.0 for n in list(libs) + ["grouped", "bound"]}
            for kind in ("fwd", "wgrad")}
    all_ok = True
    for name, h, ci, co, k, s, count in chip_smoke.RESNET56_CONVS:
        stride = (s, s)
        x, w, g = chip_smoke._mc_tensors(
            chip_smoke._mc_shape_case(h, ci, co, k, s), torch.bfloat16, gen,
            dev)
        xg, wg, gg = chip_smoke._grouped_layout(x, w, g, stride)
        acc = {}
        for n, lib in libs.items():
            mcc._libs["mc_conv"] = lib
            acc[n] = accuracy(x, w, g, k, stride)
        all_ok = all_ok and all(a[2] for a in acc.values())
        fns = {
            "fwd": (lambda: mcc.mc_conv_fwd(x, w, stride),
                    lambda: F.conv2d(xg, wg, stride=stride,
                                     groups=chip_smoke.MC_K)),
            "wgrad": (lambda: mcc.mc_conv_wgrad(x, g, k, k, stride),
                      lambda: torch.nn.grad.conv2d_weight(
                          xg, wg.shape, gg, stride=stride,
                          groups=chip_smoke.MC_K)),
        }
        row = {"shape": name, "count": count}
        for kind, (kernel, grouped) in fns.items():
            times = {n: [] for n in libs}
            for i, n in enumerate(order):
                mcc._libs["mc_conv"] = libs[n]
                times[n].append(chip_smoke._time_ms(kernel, flush,
                                                    hide=True))
                if i == len(libs) - 1:
                    lib_ms = chip_smoke._time_ms(grouped, flush, hide=True)
            nbytes, flops = chip_smoke.mc_work(h, ci, co, k, s, kind)
            bound_ms, bound_by = chip_smoke._bound(nbytes, flops, card,
                                                   peak="bf16")
            med = {n: statistics.median(ts) for n, ts in times.items()}
            for n in libs:
                sums[kind][n] += count * med[n]
            sums[kind]["grouped"] += count * lib_ms
            sums[kind]["bound"] += count * bound_ms
            row[kind] = {"ms": times, "grouped_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bytes": nbytes, "flops": flops}
            print(f"mc_conv.{kind} at {name} (x{count}), K {chip_smoke.MC_K},"
                  f" B {chip_smoke.MC_B}, bf16, cold L2, median of 50, in "
                  f"the order {' '.join(order)}: "
                  + ", ".join(f"{n} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                              for n, ts in times.items())
                  + f"; grouped library call {lib_ms:.4f} ms; bound "
                  f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.3f} GFLOP at {peak / 1e12:.0f} TFLOP/s); "
                  + ", ".join(f"{n} / grouped {med[n] / lib_ms:.2f}x"
                              for n in libs), flush=True)
        row["max_abs_err"] = {n: {"fwd": a[0], "wgrad": a[1]}
                              for n, a in acc.items()}
        row["within_tolerance"] = {n: a[2] for n, a in acc.items()}
        print(f"  max |err| (fwd / dw) " + ", ".join(
            f"{n} {a[0]:.3g} / {a[1]:.3g}{'' if a[2] else ' FAILED'}"
            for n, a in acc.items()), flush=True)
        result["shapes"].append(row)
    for kind, tot in sums.items():
        print(f"mc_conv.{kind} summed over one pass's 57 convs: "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in tot.items()),
              flush=True)
    result["pass_sums"] = sums
    result["all_within_tolerance"] = all_ok
    mcc._libs.pop("mc_conv", None)
    print(json.dumps(result), flush=True)
    if not all_ok:
        raise SystemExit("profile_mc_conv: a build disagrees with the plain "
                         "versions")


if __name__ == "__main__":
    main()
