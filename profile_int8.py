#!/usr/bin/env python3
"""The int8 weight product (kernel 9, ``fedml_tpu_torch/csrc/pallas_ops.cu``)
and the wire dequantize (kernel 11, ``csrc/wire_compression.cu``) on one
NVIDIA card, beside an empty launch, the library calls, other builds of
the dequantize and an earlier checkout's phase-4 timings, in turns.

Run from the root of a checkout:

    python3 profile_int8.py [--gemv-max-m N ...] [--other NAME=PATH ...]
                            [--other-mm NAME=PATH ...] [--parent DIR]

Every time is the device time of one call (a decode step's 72 products,
or one product, or one dequantize) on a cold L2, the host hidden behind a
GPU sleep, median of 50, each probe timed in turns (the list, then the
list reversed).

* Kernel 9, over one GPT-2-small decode step's 72 products
  (``chip_smoke.gpt2_params`` quantized by ``quantize_lm_params``) at M 1,
  2, 4, 8, 16 and 64, float32 x: the port's call, the plain version (the
  cuBLAS pair ``matmul(x, f32(q)) · s``) and ``aten._weight_int8pack_mm``
  on ``[N, K]`` int8, each ``--gemv-max-m N`` build (``pallas_ops.cu``
  with the CUDA cores taking M <= N: 0 puts every M on the tensor cores,
  16 the decode batches up to 16 on the CUDA cores) and each
  ``--other-mm`` build (a ``pallas_ops.cu`` with the same C interface,
  such as one with other cluster sizes); then one product of each shape
  (wq, w1, w2) at M 1 and 64.  Every output is held to the
  plain version at ``K · 2^-24 · (|x| @ |q|) · s``.  Each M's bound: the
  bytes at the memory rate against the operations of the path
  (``chip_smoke.int8_bound``).
* Kernel 11 at ResNet-56's 860,026 values: one segment (the uplink) in the
  flat form and through a one-row device table, ``torch.mul`` on the
  ``[1680, 512]`` view; the broadcast's 287 segments by value and through
  the 287-row device table; each
  ``--other`` build (a ``wire_compression.cu`` with the same C interface,
  such as one with 16 values a thread) flat and by value.  Every output is
  held bit for bit to the plain version.

With ``--parent DIR`` (a checkout of an earlier commit) it runs
``chip_smoke.po_timing_phase`` and ``wire_timing_phase`` of that checkout
and of this one in subprocesses, in turns (parent, new, new, parent), and
prints their phase lines.  Every line of numbers starts with the card's
name and power limit as ``nvidia-smi`` reports them; the last line is one
JSON object of all of it.
It needs one CUDA card and ``nvcc``; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import torch

import chip_smoke
import fedml_tpu_torch
from fedml_tpu_torch.ops import cuda_build
from fedml_tpu_torch.ops import pallas_ops as po
from fedml_tpu_torch.ops import wire_compression as wc
from fedml_tpu_torch.serving.quantization import quantize_lm_params

MM_FNS = ("fedml_int8_matmul", "fedml_int8_matmul_plan",
          "fedml_int8_gemv_max_m", "fedml_cuda_error_string")
WIRE_FNS = ("fedml_dequantize_int8", "fedml_dequantize_int8_flat",
            "fedml_dequantize_int8_rows", "fedml_dequantize_rows_capacity",
            "fedml_wire_block", "fedml_cuda_error_string")
GEMV_MAX_M = re.compile(r"constexpr int kGemvMaxM = \d+;")
M_VALUES = (1, 2, 4, 8, 16, 64)

#: runs one checkout's phase-4 timings of kernels 9 and 11 in its own process
PHASE = """
import chip_smoke, fedml_tpu_torch
name, _ = chip_smoke.device_phase()
dev = fedml_tpu_torch.device.get_device(
    fedml_tpu_torch.Config(device_type="cuda"))
chip_smoke.po_timing_phase(dev, name)
chip_smoke.wire_timing_phase(dev, name)
"""
PHASE_LINES = ("pallas_ops.int8_matmul over", "wire_compression.dequantize at",
               "wire kernels over the broadcast")


def say(card, text):
    print(f"{card} | {text}", flush=True)


def turns(probes, flush):
    """Each probe's device time, in turns: the list, then reversed."""
    order = list(probes) + list(reversed(probes))
    times = {n: [] for n in probes}
    for n in order:
        times[n].append(chip_smoke._time_ms(
            probes[n], flush, **chip_smoke._hidden(probes[n])))
    return times


def gemv_variant(n):
    """``pallas_ops.cu`` built with the CUDA cores taking M <= ``n``."""
    src = (cuda_build.CSRC / "pallas_ops.cu").read_text()
    text, hits = GEMV_MAX_M.subn(f"constexpr int kGemvMaxM = {n};", src)
    if hits != 1:
        raise RuntimeError("pallas_ops.cu: kGemvMaxM not found once")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = cuda_build.BUILD_DIR / f"pallas_ops_gemv{n}.cu"
    path.write_text(text)
    return cuda_build.load_variant(f"pallas_ops_gemv{n}", str(path),
                                   po._kernel_lib(), MM_FNS)


def other_step(lib, xs, mats, dev):
    """A decode step's products through another build's C interface, into
    fresh outputs."""
    stream = torch.cuda.current_stream(dev).cuda_stream

    def step():
        outs = []
        for q, s in mats:
            x = xs[q.shape[0]]
            out = torch.empty(x.shape[0], q.shape[1], device=dev)
            rc = lib.fedml_int8_matmul(x.data_ptr(), 0, x.stride(0),
                                       q.data_ptr(), s.data_ptr(),
                                       out.data_ptr(), x.shape[0],
                                       q.shape[0], q.shape[1],
                                       dev.index or 0, stream)
            if rc != 0:
                raise RuntimeError(f"int8_matmul launch failed: {rc}")
            outs.append(out)
        return outs
    return step


def int8_probes(mats, m, dev, card, others):
    """name -> a decode step's 72 products at batch m, each output checked
    against the plain version first."""
    xs = chip_smoke.decode_inputs(m, dev, seed=17 + m)
    packed = [(q.t().contiguous(), s) for q, s in mats]

    probes = {"port": lambda: [po.int8_matmul(xs[q.shape[0]], q, s)
                               for q, s in mats]}
    for label, lib in others.items():
        probes[label] = other_step(lib, xs, mats, dev)
    for path, fn in list(probes.items()):
        for out, (q, s) in zip(fn(), mats):
            x = xs[q.shape[0]]
            chip_smoke._order_err(
                out, po.int8_matmul_reference(x, q, s),
                po.int8_matmul_reference(x.abs(), q.abs(), s), q.shape[0],
                f"int8_matmul {path} M {m}")
    probes["plain"] = lambda: [po.int8_matmul_reference(xs[q.shape[0]], q, s)
                               for q, s in mats]
    try:
        torch.ops.aten._weight_int8pack_mm(xs[packed[0][0].shape[1]],
                                           *packed[0])
        probes["_weight_int8pack_mm"] = lambda: [
            torch.ops.aten._weight_int8pack_mm(xs[qt.shape[1]], qt, s)
            for qt, s in packed]
    except (RuntimeError, NotImplementedError) as e:
        say(card, f"_weight_int8pack_mm raised: {str(e).splitlines()[0]}")
    return probes


def product_probes(mats, dev):
    """name -> one product of each of the step's three shapes at M 1 and 64."""
    probes = {}
    shapes = {(768, 768): "wq", (768, 3072): "w1", (3072, 768): "w2"}
    seen = set()
    for q, s in mats:
        key = tuple(q.shape)
        if key in seen:
            continue
        seen.add(key)
        for m in (1, 64):
            x = chip_smoke.decode_inputs(m, dev, seed=23)[key[0]]
            probes[f"{shapes[key]} M {m}"] = (
                lambda x=x, q=q, s=s: po.int8_matmul(x, q, s))
    return probes


def bind_wire(lib, dev, q, s, out, lengths):
    """name -> a dequantize through ``lib``'s C interface in each form: q[0]
    and s[0] one segment, q[1] and s[1] the segments ``lengths``."""
    dev_i = dev.index or 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    d = q[0].numel()
    rows_flat = wc.n_blocks(d)
    start = wc.segments_by_value(lengths)
    table1 = wc._segment_table((d,), dev)
    table = wc._segment_table(tuple(lengths), dev)

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"dequantize launch failed: CUDA error {rc}")


    return {
        "flat": lambda: check(lib.fedml_dequantize_int8_flat(
            q[0].data_ptr(), s[0].data_ptr(), d, rows_flat, out.data_ptr(),
            dev_i, stream)),
        "one-row table": lambda: check(lib.fedml_dequantize_int8(
            q[0].data_ptr(), s[0].data_ptr(), table1.table.data_ptr(), 1,
            rows_flat, out.data_ptr(), dev_i, stream)),
        "287 by value": lambda: check(lib.fedml_dequantize_int8_rows(
            q[1].data_ptr(), s[1].data_ptr(), start.ctypes.data,
            start.size - 1, out.data_ptr(), dev_i, stream)),
        "287-row table": lambda: check(lib.fedml_dequantize_int8(
            q[1].data_ptr(), s[1].data_ptr(), table.table.data_ptr(),
            table.n_seg, table.rows, out.data_ptr(), dev_i, stream)),
    }


def parent_turns(parent, card):
    """The phase-4 lines of kernels 9 and 11 from ``parent`` and from this
    checkout, in subprocesses, in turns."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = []
    for label, root in (("parent", parent), ("new", here), ("new", here),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", PHASE], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"phase 4 in {root} failed:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        lines = [x.strip() for x in proc.stdout.splitlines()
                 if any(p in x for p in PHASE_LINES)]
        for line in lines:
            say(card, f"{label}: {line}")
        out.append((label, lines))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another wire_compression.cu to time flat and by "
                         "value")
    ap.add_argument("--gemv-max-m", action="append", default=[], type=int,
                    metavar="N",
                    help="a pallas_ops.cu build whose CUDA cores take M <= N, "
                         "to time at each M")
    ap.add_argument("--other-mm", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another pallas_ops.cu to time at each M")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout whose phase-4 timings of kernels 9 and "
                         "11 to run in turns with this one's")
    args = ap.parse_args()
    name, smi = chip_smoke.device_phase()
    dev = fedml_tpu_torch.device.get_device(
        fedml_tpu_torch.Config(device_type="cuda"))
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    result = {"card": smi, "int8": {}, "products": {}, "dequantize": {}}
    empty = {"empty launch": lambda: torch.cuda._sleep(0)}

    # kernel 9
    mats = chip_smoke.decode_matrices(quantize_lm_params(
        chip_smoke.gpt2_params(dev)))
    say(smi, f"int8 product: the CUDA cores take M <= {po.gemv_max_m()}")
    mm_others = {f"gemv_max_m {n}": gemv_variant(n)
                 for n in args.gemv_max_m}
    for spec in args.other_mm:
        label, path = spec.split("=", 1)
        mm_others[label] = cuda_build.load_variant(
            f"pallas_ops_{label}", path, po._kernel_lib(), MM_FNS)
    for m in M_VALUES:
        probes = {**empty, **int8_probes(mats, m, dev, smi, mm_others)}
        chip_smoke._time_ms(probes["port"], flush)   # clocks up
        times = turns(probes, flush)
        nbytes, flops = chip_smoke.decode_work(mats, m)
        bound_ms, bound_by, text = chip_smoke.int8_bound(nbytes, flops, m,
                                                         name, dev)
        plan = po.int8_matmul_plan(m, 768, 768, torch.float32, dev)
        result["int8"][m] = {"ms": times, "bound_ms": bound_ms,
                             "bound_by": bound_by, "plan_wq": plan}
        for n, ts in times.items():
            med = statistics.median(ts)
            share = (f", {bound_ms / med:.1%} of the bound"
                     if n not in ("empty launch",) else "")
            say(smi, f"int8 step (72 products) M {m}: {n} "
                f"{' / '.join(f'{t:.4f}' for t in ts)} ms (median "
                f"{med:.4f}){share}")
        say(smi, f"int8 step M {m}: bound {bound_ms:.4f} ms ({bound_by}; "
            f"{text}); wq plan {plan}")
    probes = {**empty, **product_probes(mats, dev)}
    times = turns(probes, flush)
    result["products"] = times
    for n, ts in times.items():
        say(smi, f"int8 one product {n}: {' / '.join(f'{t:.4f}' for t in ts)}"
            f" ms")

    # kernel 11
    lengths = chip_smoke.resnet56_wire_lengths()
    d = sum(lengths)
    gen = torch.Generator().manual_seed(6)
    x = (torch.randn(d, generator=gen) * 1e-2).to(dev)
    q0, s0 = wc.quantize_int8_blocked(x)
    q1, s1 = wc.quantize_int8_blocked(x, lengths)
    want0 = wc.dequantize_int8_reference(q0, s0, d)
    want1 = wc.dequantize_int8_blocked(q1.cpu(), s1.cpu(), d, lengths)
    rows = wc.n_blocks(d)
    q_rows = torch.zeros(rows * wc.BLOCK, dtype=torch.int8, device=dev)
    q_rows[:d] = q0
    q_rows = q_rows.view(rows, wc.BLOCK)
    out = torch.empty(d, dtype=torch.float32, device=dev)
    lib_out = torch.empty(rows, wc.BLOCK, dtype=torch.float32, device=dev)
    new = wc._kernel_lib()
    builds = {"new": new}
    for spec in args.other:
        label, path = spec.split("=", 1)
        builds[label] = cuda_build.load_variant(f"wire_compression_{label}",
                                                path, new, WIRE_FNS)
    probes = {**empty,
              "torch.mul one segment": lambda: torch.mul(
                  q_rows, s0[:, None], out=lib_out),
              "port one segment": lambda: wc.dequantize_int8_blocked(q0, s0,
                                                                     d),
              "port 287 segments": lambda: wc.dequantize_int8_blocked(
                  q1, s1, d, lengths)}
    for label, lib in builds.items():
        forms = bind_wire(lib, dev, (q0, q1), (s0, s1), out, lengths)
        for form, fn in forms.items():
            if label != "new" and "table" in form:
                continue
            out.zero_()
            fn()
            torch.cuda.synchronize()
            chip_smoke._same_bits(out, want0 if "287" not in form
                                  else want1.to(dev),
                                  f"dequantize {label} {form}")
            probes[f"{label} {form}"] = fn
    probes["torch.mul one segment"]()
    torch.cuda.synchronize()
    chip_smoke._same_bits(lib_out.reshape(-1)[:d], want0, "torch.mul")
    chip_smoke._time_ms(probes["port one segment"], flush)
    times = turns(probes, flush)
    nbytes = d + 4 * rows + 4 * d
    bound_ms, _ = chip_smoke._bound(nbytes, d, name)
    result["dequantize"] = {"ms": times, "bound_ms": bound_ms,
                            "segments": len(lengths)}
    for n, ts in times.items():
        say(smi, f"dequantize at D {d} ({len(lengths)} segments where named)"
            f": {n} {' / '.join(f'{t:.4f}' for t in ts)} ms (median "
            f"{statistics.median(ts):.4f}; bound {bound_ms:.5f})")

    if args.parent:
        result["phase4_turns"] = parent_turns(args.parent, smi)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
