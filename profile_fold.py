#!/usr/bin/env python3
"""The adapter fold (``fedml_tpu_torch/csrc/fold_delta.cu``) at the fed-LLM
path's shape on one NVIDIA card: its launch forms beside an empty launch
and ``torch.add``, other builds of it, and an earlier checkout's whole
call, in turns.

Run from the root of a checkout:

    python3 profile_fold.py [--other NAME=PATH ...] [--parent DIR]

At BERT-tiny's rank-4 adapters (11,112 float32 values over 10 leaves,
``server_lr`` 1; ``chip_smoke._adapter_tree``), cold L2, the host hidden
behind a GPU sleep, median of 50, in turns (the list, then the list
reversed), it times an empty launch (``torch.cuda._sleep(0)``: a kernel
that reads the clock once), ``torch.add(a, d, alpha=1)`` on the flat
buffers, and this build's kernel through its C interface in each launch
form: one flat range, the 10 leaves in a device table and a one-row
device table (what a table costs beside the flat range); then each
``--other`` build (a source with the same C interface, such as one with
other block sizes) in the flat form.  Every output is held bit for bit to
``fold_delta_reference``.  With ``--parent DIR`` (a checkout of an earlier
commit) it runs ``chip_smoke.fold_timing_phase`` of that checkout and of
this one in subprocesses, in turns (parent, new, new, parent), and prints
their phase lines.  It prints the card's name and power limit, one line
per probe, and last one JSON object of all of it.  It needs one CUDA card
and ``nvcc``; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys

import torch

import chip_smoke
from fedml_tpu_torch.ops import cuda_build, epilogue
from fedml_tpu_torch.utils.tree import tree_leaves

FNS = ("fedml_fold_delta_flat", "fedml_fold_delta_table",
       "fedml_fold_delta_chunk", "fedml_fold_delta_table_cols",
       "fedml_cuda_error_string")

#: runs one checkout's phase-4 fold timing in its own process
PHASE = """
import json, chip_smoke, fedml_tpu_torch
name, _ = chip_smoke.device_phase()
dev = fedml_tpu_torch.device.get_device(
    fedml_tpu_torch.Config(device_type="cuda"))
print("FOLD_ROW " + json.dumps(chip_smoke.fold_timing_phase(dev, name)))
"""


def rows_of(sizes, chunk):
    """The leaves' segments (a_off, d_off, out_off, len, first_chunk) for
    buffers laid out alike, and the blocks in all."""
    starts = list(itertools.accumulate([0] + sizes[:-1]))
    firsts = list(itertools.accumulate([0] + [-(-n // chunk)
                                              for n in sizes]))
    return [(s, s, s, n, f) for s, n, f in zip(starts, sizes, firsts)], \
        firsts[-1]


def launches(lib, a, d, out, sizes, dev):
    """name -> a call of ``lib`` in each launch form, writing ``out``."""
    dev_i = dev.index or 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = a.numel()
    chunk = lib.fedml_fold_delta_chunk()
    leaves, n_chunks = rows_of(sizes, chunk)
    one = [(0, 0, 0, n, 0)]
    one_chunks = -(-n // chunk)
    keep = []

    def table(rows):
        t = torch.tensor(rows, dtype=torch.int64, device=dev)
        keep.append(t)
        return t.data_ptr()

    ptrs = (a.data_ptr(), d.data_ptr(), out.data_ptr())
    t10, t1 = table(leaves), table(one)

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"fold_delta launch failed: CUDA error {rc}")

    calls = {
        "flat": lambda: check(lib.fedml_fold_delta_flat(
            *ptrs, n, 1.0, 0, dev_i, stream)),
        "table x10": lambda: check(lib.fedml_fold_delta_table(
            *ptrs, t10, len(leaves), n_chunks, 1.0, 0, dev_i, stream)),
        "one-row table": lambda: check(lib.fedml_fold_delta_table(
            *ptrs, t1, 1, one_chunks, 1.0, 0, dev_i, stream)),
    }
    return calls, keep


def parent_turns(parent):
    """chip_smoke.fold_timing_phase of ``parent`` and of this checkout, in
    subprocesses, in turns: (label, row, its phase line) each."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = []
    for label, root in (("parent", parent), ("new", here), ("new", here),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", PHASE], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"fold_timing_phase in {root} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        lines = proc.stdout.splitlines()
        row = json.loads(next(x for x in lines if x.startswith("FOLD_ROW "))
                         [len("FOLD_ROW "):])
        text = next(x for x in lines if "fold_delta at" in x)
        print(f"{label}: {text.strip()}", flush=True)
        out.append((label, row))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another fold_delta.cu to time in the flat form")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout whose fold_timing_phase to run in "
                         "turns with this one's")
    args = ap.parse_args()
    card, smi = chip_smoke.device_phase()
    dev = torch.device("cuda", 0)

    gen = torch.Generator().manual_seed(9)
    a_tree, _, a, d = chip_smoke._adapter_tree(4, torch.float32, dev, gen)
    sizes = [t.numel() for t in tree_leaves(a_tree)]
    want = epilogue.fold_delta_reference([a], [d], 1.0)[0]
    out = torch.empty_like(a)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    new = epilogue._kernel_lib("fold_delta")
    probes, keep = launches(new, a, d, out, sizes, dev)
    probes = {"empty launch": lambda: torch.cuda._sleep(0),
              "torch.add": lambda: torch.add(a, d, alpha=1.0, out=out),
              **probes}
    for spec in args.other:
        name, path = spec.split("=", 1)
        lib = cuda_build.load_variant(f"fold_delta_{name}", path, new, FNS)
        calls, k = launches(lib, a, d, out, sizes, dev)
        probes[f"{name} flat (chunk {lib.fedml_fold_delta_chunk()})"] = \
            calls["flat"]
        keep += k
    for name, fn in probes.items():
        if name == "empty launch":
            continue
        out.zero_()
        fn()
        torch.cuda.synchronize()
        chip_smoke._same_bits(out, want, f"fold_delta {name}")
    # the card's clocks up before the first timed call
    chip_smoke._time_ms(probes["flat"], flush)
    order = list(probes) + list(reversed(probes))
    times = {n: [] for n in probes}
    for n in order:
        times[n].append(chip_smoke._time_ms(probes[n], flush, hide=True))
    n_values = a.numel()
    bound_ms, _ = chip_smoke._bound(12 * n_values, 2 * n_values, card)
    result = {"card": smi, "values": n_values, "leaves": len(sizes),
              "bound_ms": bound_ms, "ms": times,
              "chunk": new.fedml_fold_delta_chunk()}
    for n, ts in times.items():
        print(f"fold at {n_values} f32 values over {len(sizes)} leaves, "
              f"cold L2, host hidden, median of 50: {n} "
              f"{' / '.join(f'{x:.4f}' for x in ts)} ms "
              f"(median {statistics.median(ts):.4f})", flush=True)
    if args.parent:
        result["phase4_turns"] = parent_turns(args.parent)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
