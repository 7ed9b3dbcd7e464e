"""The port's pure cost model (``repro_torch.launch.roofline``) against
``repro.launch.roofline``, with the JAX module's machine constants passed
in as a :class:`~repro_torch.launch.roofline.Machine`: model FLOPs, NoC
cycles, bucket readiness and the modeled overlap timeline of the
bucketed DP reduction, record for record, on JAX's synthetic leaves and
on yi-6b's smoke grads; then the modeled wire bytes against what the
executor moves in a bucketed train step on the CPU.

Tolerance: none. Every number is integer arithmetic or the same float
expression in the same order; records and timelines must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import chainwrite as cw  # noqa: E402
from repro_torch.data.pipeline import MarkovSource  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

# The JAX module's machine, passed in: the port itself carries only the card's.
JAX_MACHINE = TR.Machine(name="repro.launch.roofline constants", peak_flops=JR.PEAK_FLOPS,
                         hbm_bw=JR.HBM_BW, link_bw=JR.ICI_BW)

SYNTHETIC = [((256, 128), "float32"), ((512,), "float32"), ((128, 128), "bfloat16"),
             ((64, 64), "float32")]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _leaf_sets():
    jax_smoke = jax.tree.leaves(jax.eval_shape(
        lambda: JT.model_init(jax.random.PRNGKey(0), JC.get_smoke_config("yi-6b"))))
    port_smoke = leaves(TT.model_init(torch.Generator(), TC.get_smoke_config("yi-6b"),
                                      device="meta"))
    return {
        "synthetic": ([jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in SYNTHETIC],
                      [_meta(s, d) for s, d in SYNTHETIC], 64 << 10),
        "yi6b_smoke": (jax_smoke, port_smoke, 16 << 10),
    }


LEAF_SETS = _leaf_sets()


def test_flop_and_cycle_helpers_match_jax():
    for n, tokens in ((0, 1), (1, 1), (6_061_035_520, 4096), (123_457, 1 << 20)):
        for kind in ("train", "prefill", "decode"):
            assert TR.model_flops(n, tokens, kind) == JR.model_flops(n, tokens, kind)
        assert TR.backward_flops(n, tokens) == JR.backward_flops(n, tokens)
    for secs in (0.0, 1e-9, 3.7e-6, 0.0125, 2.5):
        for link in (64, 32, 128):
            assert TR.noc_cycles(secs, link, machine=JAX_MACHINE) == JR.noc_cycles(secs, link)
    buckets = [0, 1, 4096, 65_536, 1_000_003, 250_000_000]
    for tokens in (1, 1024, 1 << 16):
        for link in (64, 16):
            assert TR.bucket_ready_cc(buckets, tokens, machine=JAX_MACHINE, link_bw=link) == \
                JR.bucket_ready_cc(buckets, tokens, link_bw=link)
    assert TR.bucket_ready_cc([0], 1) == [0] and TR.noc_cycles(0.0) == 0


def test_h100_machine_is_the_card():
    m = TR.H100_SXM
    assert (m.peak_flops, m.peak_flops_f32, m.peak_flops_tf32) == (989e12, 67e12, 495e12)
    assert (m.hbm_bw, m.link_bw) == (3.35e12, 450e9)
    assert "H100" in m.name and "700 W" in m.name
    # a faster link turns the same seconds into more cycles of 64 B
    assert TR.noc_cycles(1e-3) == round(1e-3 * 450e9 / 64)


@pytest.mark.parametrize("leaf_set", sorted(LEAF_SETS))
@pytest.mark.parametrize("topology", [None, "pods=2:interpod_bw=0.25"])
@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("algo", ["rs_ag", "rotation"])
@pytest.mark.parametrize("num_chains", [1, 2, "auto"])
def test_modeled_train_overlap_matches_jax(leaf_set, topology, wire, algo, num_chains):
    """Buckets, readiness, per-bucket K, padded bytes, CC and wire bytes,
    the overlap timeline and its efficiency: equal to JAX's on an
    8-rank ring."""
    jleaves, tleaves, bucket = LEAF_SETS[leaf_set]
    kw = dict(bucket_bytes=bucket, num_chains=num_chains, algo=algo, wire_dtype=wire,
              topology=topology)
    want = JR.modeled_train_overlap(jleaves, 8, 1 << 12, **kw)
    got = TR.modeled_train_overlap(tleaves, 8, 1 << 12, machine=JAX_MACHINE, **kw)
    assert len(got["buckets"]) >= 2
    assert got == want


def test_modeled_overlap_on_the_card_machine_keeps_wire_bytes():
    """The machine moves readiness and nothing else: wire bytes, padding
    and each bucket's K are the same on the card's machine as on JAX's
    constants, and the faster backward makes buckets ready sooner in
    seconds."""
    _, tleaves, bucket = LEAF_SETS["yi6b_smoke"]
    card = TR.modeled_train_overlap(tleaves, 8, 1 << 12, bucket_bytes=bucket)
    tpu = TR.modeled_train_overlap(tleaves, 8, 1 << 12, bucket_bytes=bucket,
                                   machine=JAX_MACHINE)
    strip = ("ready_cc", "comm_cc")
    assert [{k: v for k, v in b.items() if k not in strip} for b in card["buckets"]] == \
        [{k: v for k, v in b.items() if k not in strip} for b in tpu["buckets"]]
    assert card["total_wire_bytes"] == tpu["total_wire_bytes"]
    last = card["buckets"][-1]["ready_cc"] / TR.H100_SXM.link_bw
    assert last < tpu["buckets"][-1]["ready_cc"] / JAX_MACHINE.link_bw


@pytest.mark.parametrize("num_chains,compress", [(2, False), ("auto", False), (2, True)])
def test_modeled_wire_bytes_equal_the_executor_count(num_chains, compress):
    """A bucketed smoke train step of 4 virtual ranks on the CPU: the
    executor's wire bytes (``wire_counter``) equal the model's
    ``total_wire_bytes`` for the step's own leaves and knobs, exactly."""
    cfg = TC.get_smoke_config("yi-6b")
    bucket = 16 << 10
    params = TT.model_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in MarkovSource(cfg.vocab_size, 32, 8, seed=1).batch(0).items()}
    step = make_train_step(cfg, adamw.OptConfig(), collectives="torrent",
                           num_chains=num_chains, compress_grads=compress,
                           bucket_bytes=bucket, mesh=make_host_mesh(data=4), loss_chunks=4)
    model = TR.modeled_train_overlap(leaves(params), 4, 8 * 32 // 4, bucket_bytes=bucket,
                                     num_chains=num_chains,
                                     wire_dtype="int8" if compress else None)
    cw.wire_counter.reset()
    step(params, adamw.init(params), batch)
    assert cw.wire_counter.bytes == cw.wire_counter.modeled_bytes() > 0
    assert model["total_wire_bytes"] == cw.wire_counter.bytes
    assert len(model["buckets"]) >= 2
