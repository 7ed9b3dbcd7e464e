"""The port's version of the JAX package's int8 + EF end-to-end training
test: two stacked ``Trainer`` runs of 25 steps (the exact wire, and the
int8 wire with error feedback across an injected failure). It is split
from ``tests/test_torch_train.py`` so that a parallel run can spread the
two files, and its two runs, which share nothing, go at once.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as TTrain  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "yi-6b"


def test_trainer_int8_ef_with_restart(tmp_path):
    """The port's version of the JAX int8 + EF end-to-end test: the EF
    residual is checkpointed and restored across an injected failure,
    and the run tracks the exact-wire run within 0.15."""
    base = dict(arch=ARCH, smoke=True, steps=25, global_batch=8, seq_len=32,
                peak_lr=2e-3, warmup_steps=5, ckpt_every=10, loss_chunks=2,
                log_every=100, collectives="torrent", dp=4)
    f32 = TTrain.Trainer(TTrain.TrainConfig(ckpt_dir=str(tmp_path / "f32"), **base),
                         device="cpu")
    tr = TTrain.Trainer(TTrain.TrainConfig(ckpt_dir=str(tmp_path / "int8"),
                                           compress_grads=True, fail_at=(13,), **base),
                        device="cpu")
    with ThreadPoolExecutor(2) as ex:
        runs = [ex.submit(t.run) for t in (f32, tr)]
        out_f32, out_int8 = (r.result() for r in runs)
    assert out_int8["final_step"] == 25 and out_int8["restarts"] == 1
    assert np.isfinite(out_int8["losses"]).all()
    assert out_int8["last_loss"] < out_int8["first_loss"]
    assert abs(out_int8["last_loss"] - out_f32["last_loss"]) < 0.15
    assert any(float(r.abs().max()) > 0 for r in leaves(tr.state["ef"]))
