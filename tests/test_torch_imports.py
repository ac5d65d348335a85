"""The port stands alone: no module of ``fedml_tpu_torch`` and no line of
``chip_smoke.py``, ``profile_cross_silo.py``, ``profile_flash.py``,
``profile_fold.py``, ``profile_int8.py``, ``profile_mc_conv.py`` or
``profile_streaming.py`` imports JAX, flax, optax or the JAX package —
checked on the source, so a lazy import inside a function counts too."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fedml_tpu"}
SOURCES = sorted(p.relative_to(REPO).as_posix() for p in
                 (REPO / "fedml_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "profile_cross_silo.py", "profile_flash.py",
    "profile_fold.py", "profile_int8.py", "profile_mc_conv.py",
    "profile_streaming.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_port_has_modules_to_check():
    for rel in ("ops/epilogue.py", "ops/pallas_attention.py",
                "ops/pallas_mc_conv.py", "ops/pallas_ops.py",
                "core/mpc/secagg.py", "core/mpc/lightsecagg.py",
                "serving/quantization.py",
                "models/nlp.py", "data/natural.py", "data/tff_text.py",
                "ops/wire_compression.py", "utils/compression.py",
                "utils/serialization.py", "utils/checkpoint.py",
                "utils/tree.py",
                "core/distributed/communication/message.py",
                "core/distributed/communication/inprocess/"
                "inproc_comm_manager.py",
                "core/distributed/fedml_comm_manager.py",
                "core/alg_frame/client_trainer.py",
                "core/alg_frame/server_aggregator.py",
                "ml/trainer/default_trainer.py",
                "cross_silo/message_define.py",
                "cross_silo/client/fedml_client_master_manager.py",
                "cross_silo/client/trainer_dist_adapter.py",
                "cross_silo/server/fedml_aggregator.py",
                "cross_silo/server/fedml_server_manager.py",
                "cross_silo/runner.py", "train/llm/lora.py",
                "train/llm/trainer.py", "train/fed_llm/config.py",
                "train/fed_llm/delta_round.py", "train/fed_llm/trainer.py",
                "train/fed_llm/aggregator.py"):
        assert f"fedml_tpu_torch/{rel}" in SOURCES
    assert len(SOURCES) >= 48


@pytest.mark.parametrize("rel", SOURCES)
def test_no_jax_import(rel):
    tree = ast.parse((REPO / rel).read_text(encoding="utf-8"), filename=rel)
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f"{rel} imports {bad}"
