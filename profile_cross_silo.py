#!/usr/bin/env python3
"""Where the int8 wire's extra time goes on the cross-silo path, on one
NVIDIA card.

Run from the root of a checkout:

    python3 profile_cross_silo.py

It drives ``chip_smoke.py``'s cross-silo main path (phase 11: synchronous
FedAvg over INPROC, ResNet-56 at full width in bfloat16, 8 silos, 3
rounds) through the five-step entry, with ``wire_compression: int8`` and
raw, each in two schedules:

* ``free`` — as the package runs it: every silo thread decodes, trains and
  encodes on its own, and only load → train → copy out holds
  ``ModelBundle.lock``;
* ``held`` — each silo's whole turn (the broadcast's decode, the local
  update and the upload's encode) under one process-wide lock, so no
  silo's codec work overlaps another silo's training.

The eight runs go in turns (int8 free, int8 held, raw free, raw held, then
the reverse), so each pair compares inside one call.  Host-clock timers
wrap the codec's host functions (``WireCodec.encode_model``,
``decode_model``, ``encode_delta``, the server's ``decode_delta``) and the
silo's local update (``DefaultClientTrainer.train``, which in the free
schedule includes the wait for ``ModelBundle.lock``); the seconds of a
round are the server's (broadcast to aggregated).  It prints the card's
name and power limit, one line per run, one line per (wire, schedule)
with the mean round seconds of rounds 1–2 and the mean ms of each timed
call, and last one JSON object of all of it.  It needs one CUDA card and
``nvcc``; without a card it exits non-zero.
"""

from __future__ import annotations

import functools
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
from collections import defaultdict

import torch

import chip_smoke
import fedml_tpu_torch
from fedml_tpu_torch import FedMLRunner
from fedml_tpu_torch.cross_silo.client import fedml_client_master_manager
from fedml_tpu_torch.cross_silo.server import fedml_server_manager
from fedml_tpu_torch.ml.trainer.default_trainer import DefaultClientTrainer
from fedml_tpu_torch.utils.compression import WireCodec

#: (wire, schedule) in the order they run
TURNS = [("int8", "free"), ("int8", "held"), ("raw", "free"),
         ("raw", "held"), ("raw", "held"), ("raw", "free"),
         ("int8", "held"), ("int8", "free")]

_calls = defaultdict(list)
_calls_lock = threading.Lock()
_turn_lock = threading.Lock()
_hold = {"on": False}


def _timed(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            with _calls_lock:
                _calls[name].append(dt)
    return wrapper


def _held(fn):
    """A silo's message handler, under the process-wide turn lock when the
    run holds turns."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _hold["on"]:
            return fn(*args, **kwargs)
        with _turn_lock:
            return fn(*args, **kwargs)
    return wrapper


def instrument():
    WireCodec.encode_model = staticmethod(
        _timed("encode_model", WireCodec.encode_model))
    WireCodec.decode_model = staticmethod(
        _timed("decode_model", WireCodec.decode_model))
    WireCodec.encode_delta = _timed("encode_delta", WireCodec.encode_delta)
    fedml_server_manager.decode_delta = _timed(
        "decode_delta", fedml_server_manager.decode_delta)
    DefaultClientTrainer.train = _timed("train", DefaultClientTrainer.train)
    client = fedml_client_master_manager.ClientMasterManager
    client.handle_message_init = _held(client.handle_message_init)
    client.handle_message_receive_model_from_server = _held(
        client.handle_message_receive_model_from_server)


def run_once(turn, wire, schedule):
    gc.collect()
    torch.cuda.synchronize()
    _hold["on"] = schedule == "held"
    with _calls_lock:
        _calls.clear()
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        **chip_smoke.CS_CONFIG, run_id=f"profile_cs_{wire}_{schedule}_{turn}",
        wire_compression="int8" if wire == "int8" else None))
    device = fedml_tpu_torch.device.get_device(args)
    dataset = fedml_tpu_torch.data.load(args)
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    runner = FedMLRunner(args, device, dataset, bundle)
    final = runner.run()
    torch.cuda.synchronize()
    rounds = [h["seconds"] for h in runner.runner.server.round_history]
    with _calls_lock:
        calls = {k: dict(n=len(v), mean_ms=1e3 * statistics.mean(v),
                         total_s=sum(v)) for k, v in sorted(_calls.items())}
    print(f"run {turn}: wire {wire}, {schedule}: round seconds "
          f"{[round(r, 3) for r in rounds]}, test_acc "
          f"{final['test_acc']:.4f}; "
          + ", ".join(f"{k} {c['n']} x {c['mean_ms']:.2f} ms"
                      for k, c in calls.items()), flush=True)
    return dict(turn=turn, wire=wire, schedule=schedule, round_s=rounds,
                test_acc=final["test_acc"], calls=calls)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_cross_silo: torch.cuda.is_available() is "
                         "false; this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    instrument()
    runs = [run_once(i, wire, schedule)
            for i, (wire, schedule) in enumerate(TURNS)]
    summary = {}
    for key in dict.fromkeys(TURNS):
        mine = [r for r in runs if (r["wire"], r["schedule"]) == key]
        steady = [s for r in mine for s in r["round_s"][1:]]
        names = sorted({k for r in mine for k in r["calls"]})
        calls = {k: statistics.mean(r["calls"][k]["mean_ms"] for r in mine
                                    if k in r["calls"]) for k in names}
        summary["/".join(key)] = dict(round_s_after_round_0=statistics.mean(
            steady), calls_mean_ms=calls)
        print(f"{'/'.join(key)}: {statistics.mean(steady):.3f} s a round "
              f"after round 0 ({len(mine)} runs); "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in calls.items()),
              flush=True)
    print(json.dumps(dict(card=smi, runs=runs, summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
