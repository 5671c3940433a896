"""The port's production-mesh dry run (``launch/dryrun.py``) of the
families that train on a mesh beside the decoders: mamba2-370m (ssm),
xlstm-125m (xlstm), zamba2-2.7b (hybrid) and whisper-small (encdec).

Each ``train_4k`` runs one rank's step of the full-width model on the
meta device (no card, no process group), on rank 0 of the 256-rank
single-pod mesh and, for the two quick ones, of the 512-rank multi-pod
mesh: a record with the JAX record's keys, flops and collective bytes.
The families' prefill and serve shapes are recorded ``skipped`` under
ROADMAP A.8f (a placed recurrent or encoder-decoder model has no cache
placement yet).
"""
from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

# the JAX record's keys (``src/repro/launch/dryrun.py::run_one``)
JAX_RECORD = {"arch", "shape", "mesh", "step", "status", "devices",
              "lower_s", "compile_s", "flops_per_device", "bytes_per_device",
              "hlo_cost", "memory", "collectives"}
CASES = [("mamba2-370m", "single"), ("xlstm-125m", "single"),
         ("zamba2-2.7b", "single"), ("whisper-small", "single"),
         ("xlstm-125m", "multi"), ("whisper-small", "multi")]


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_dryrun_trains_every_family(tmp_path, arch, mesh):
    """``train_4k`` on rank 0 of the production mesh: status ok, what a
    rank computes (flops > 0), holds and moves (every collective kind the
    sharded step runs), written under ``tmp_path``."""
    rec = dryrun.run_one(arch, "train_4k", mesh, verbose=False,
                         results_dir=str(tmp_path))
    disk = json.loads((tmp_path / f"{arch}_train_4k_{mesh}.json")
                      .read_text())
    assert set(rec) == set(disk) == JAX_RECORD
    assert rec["status"] == "ok" and rec["step"] == "train_step"
    assert rec["devices"] == (256 if mesh == "single" else 512)
    assert rec["flops_per_device"] > 0
    assert rec["memory"]["temp_bytes"] > rec["memory"]["argument_bytes"] > 0
    coll = rec["collectives"]
    assert rec["hlo_cost"]["collective_bytes"] > 0 and coll["count"] > 0
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["all-reduce"] > 0


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_skips_serving_a_placed_recurrent_model(tmp_path, shape):
    """A placed mamba2 does not prefill or serve on a mesh yet: the record
    says skipped, under ROADMAP A.8f, and nothing says A.8e."""
    rec = dryrun.run_one("mamba2-370m", shape, "single", verbose=False,
                         results_dir=str(tmp_path))
    assert rec["status"] == "skipped" and "A.8f" in rec["reason"]
    assert "A.8e" not in json.dumps(rec)
