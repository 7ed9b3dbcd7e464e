"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline.Roofline``/``extract``) against
``repro.launch.dryrun`` and ``repro.launch.roofline``.

1. The helpers copied from JAX's dry run: ``_cell_suffix`` and
   ``_parse_num_chains`` equal JAX's on the Namespaces of
   ``tests/test_steps_and_dryrun.py`` and ``tests/test_bucketed_reduce.py``;
   ``_active_params`` equals JAX's (``jax.eval_shape`` of its
   ``model_init``) for all ten architectures at full width. Exact.
2. ``extract``: the roofline terms of a counted cost on a ``Machine``,
   with JAX's ``as_dict`` keys (``xla_raw_flops`` renamed
   ``flop_counter_flops``; ``xla_raw_bytes`` has no counterpart).
3. The meshes and executors a dry run needs: the ``(pod, data)`` group of
   a ``(2, 2, 2)`` process mesh on a fake world, and the stacked and
   process-form executors on meta tensors booking the bytes they book on
   the CPU.
4. ``run_cell`` on smoke cells (a Torrent train cell with ``overlap``,
   and a decode cell) in a fake world of 4 on a ``(2, 2)`` mesh, run in
   a subprocess: ``status`` ok, JAX's record keys under their renamed
   names, collective bytes above 0, CUDA never initialised.

JAX's active-parameter counts and the ``run_cell`` subprocess start when
the module's first test asks for them and run beside the other tests.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import chainwrite as cw  # noqa: E402
from repro_torch.core import chainwrite_dist as cwd  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch.op_cost import Cost, OpCost  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

JAX_ACTIVE = textwrap.dedent("""
    import json
    from repro import configs as C
    from repro.launch.dryrun import _active_params
    print(json.dumps({a: _active_params(a, C.get_config(a)) for a in C.ARCHS}))
""")

RUN_CELL = textwrap.dedent("""
    import json, tempfile, torch
    from repro_torch import configs as C
    from repro_torch.launch.dryrun import fake_world, run_cell
    from repro_torch.launch.mesh import make_process_mesh
    C.SHAPES["train_smoke"] = C.Shape("train_smoke", "train", 32, 4)
    C.SHAPES["decode_smoke"] = C.Shape("decode_smoke", "decode", 64, 4)
    out = {}
    with fake_world(4), tempfile.TemporaryDirectory() as d:
        mesh = make_process_mesh(model=2)
        out["train"] = run_cell("yi-6b", "train_smoke", "single", d, collectives="torrent",
                                variant="bucketed", overlap=True, mesh=mesh, smoke=True)
        out["decode"] = run_cell("deepseek-v2-lite-16b", "decode_smoke", "single", d,
                                 mesh=mesh, smoke=True)
    out["world_after"] = torch.distributed.is_initialized()
    print(json.dumps(out))
""")


def _start(code: str, jax: bool) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def background():
    """The two subprocesses, started together; each test that needs one
    reads its JSON line (once)."""
    procs = {"jax_active": _start(JAX_ACTIVE, True), "run_cell": _start(RUN_CELL, False)}
    done: dict = {}

    def result(name):
        if name not in done:
            out, err = procs[name].communicate(timeout=600)
            assert procs[name].returncode == 0, err[-3000:]
            done[name] = json.loads(out.strip().splitlines()[-1])
        return done[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


# -- 1. the helpers ----------------------------------------------------------------


def _ns(**kw):
    base = dict(collectives="xla", num_chains=1, ar_algo="rs_ag", variant="baseline",
                remat="dots", compress_grads=False)
    base.update(kw)
    return argparse.Namespace(**base)


SUFFIX_CASES = [
    _ns(),
    _ns(collectives="torrent", num_chains=2),
    _ns(collectives="torrent", num_chains="auto", ar_algo="rotation"),
    _ns(collectives="torrent", compress_grads=True),
    _ns(collectives="torrent", num_chains="auto", bucket_mb=4.0),
    _ns(collectives="torrent", num_chains="auto", bucket_mb=None),
]


@pytest.mark.parametrize("i", range(len(SUFFIX_CASES)))
def test_cell_suffix_equals_jax(i):
    ns = SUFFIX_CASES[i]
    assert TD._cell_suffix(ns) == JD._cell_suffix(ns)


def test_parse_num_chains_equals_jax():
    for v in ("1", "2", "auto"):
        assert TD._parse_num_chains(v) == JD._parse_num_chains(v)
    with pytest.raises(argparse.ArgumentTypeError):
        TD._parse_num_chains("0")


def test_active_params_equal_jax(background):
    port = {a: TD._active_params(a, TC.get_config(a)) for a in TC.ARCHS}
    assert port == background("jax_active")
    assert sorted(port) == sorted(JC.ARCHS)


def test_mem_dict_keeps_jax_keys():
    mem = {"temp_size_in_bytes": 1, "argument_size_in_bytes": 2, "peak_memory_in_bytes": 3,
           "ignored": 4}
    assert TD._mem_dict(mem) == {"temp_size_in_bytes": 1, "argument_size_in_bytes": 2,
                                 "peak_memory_in_bytes": 3}


# -- 2. extract ----------------------------------------------------------------------


def test_extract_terms_on_a_machine():
    cost = Cost(flops=1e12, bytes=6e9, bytes_lb=3e9)
    cost.coll["all-reduce"] = 4.5e8
    cost.coll["collective-permute"] = 4.5e8
    m = TR.H100_SXM
    r = TR.extract(cost, m)
    assert r.compute_s == 1e12 / m.peak_flops
    assert r.memory_s == 6e9 / m.hbm_bw and r.memory_lb_s == 3e9 / m.hbm_bw
    assert r.collective_s == 9e8 / m.link_bw
    assert r.dominant == "collective" and r.bound_s == r.collective_s
    jax_keys = set(JR.Roofline(1.0, 1.0, 1.0, {}).as_dict())
    assert set(r.as_dict()) == jax_keys - {"xla_raw_flops", "xla_raw_bytes"} | {
        "flop_counter_flops", "machine"}
    tpu = TR.Machine("TPU v5e", JR.PEAK_FLOPS, JR.HBM_BW, JR.ICI_BW)
    jr = JR.Roofline(1e12, 6e9, 9e8, {}, hbm_bytes_lb=3e9)
    tr = TR.extract(cost, tpu)
    for key in ("compute_s", "memory_s", "memory_lb_s", "collective_s", "dominant"):
        assert getattr(tr, key) == getattr(jr, key)


def test_extract_takes_the_flop_counter_count():
    counter = OpCost()
    counter.run(lambda x, w: torch.tanh(x @ w), torch.zeros(8, 64), torch.zeros(64, 64))
    r = TR.extract(counter)
    assert r.flop_counter_flops == 2 * 8 * 64 * 64
    assert r.flops == r.flop_counter_flops + 8 * 64  # the tanh
    assert r.hbm_bytes == counter.cost.bytes and r.hbm_bytes_lb == counter.cost.bytes_lb


# -- 3. meshes and executors on meta ---------------------------------------------------


def test_multi_pod_dp_group_on_a_fake_world():
    """``(pod, data, model) = (2, 2, 2)``: the DP group over pod and data
    beside a live model axis, group rank = the (pod, data) index."""
    with fake_world(8, rank=0):
        mesh = make_process_mesh(pod=2, data=2, model=2)
        g = mesh.group(("pod", "data"))
        assert dist.get_world_size(g) == 4 and dist.get_rank(g) == 0
        assert dist.get_process_group_ranks(g) == [0, 2, 4, 6]
        assert mesh._slices(("pod", "data")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
        assert mesh._slices("data") == [[0, 2], [1, 3], [4, 6], [5, 7]]
        assert dist.get_process_group_ranks(mesh.group("model")) == [0, 1]
    with fake_world(8, rank=5):
        mesh = make_process_mesh(pod=2, data=2, model=2)
        g = mesh.group(("pod", "data"))
        assert dist.get_process_group_ranks(g) == [1, 3, 5, 7] and dist.get_rank(g) == 2
    assert not dist.is_initialized()


@pytest.mark.parametrize("collective", ["all_reduce", "all_gather", "broadcast"])
def test_stacked_executor_runs_on_meta(collective):
    """The stacked executor's index work depends on shapes only: on meta
    tensors it returns the CPU run's shape and records the same bytes."""
    fn = {"all_reduce": cw.chain_all_reduce, "all_gather": cw.chain_all_gather,
          "broadcast": lambda x: cw.chain_broadcast(x, (1, 0, 3, 2), num_frames=2)}[collective]

    def run(device):
        cw.wire_counter.reset()
        out = fn(torch.zeros(4, 10, 3, device=device))
        return tuple(out.shape), cw.wire_counter.bytes

    cpu, meta = run("cpu"), run("meta")
    assert meta == cpu and meta[1] > 0


def test_process_executor_on_a_fake_group_names_its_transport():
    with fake_world(4):
        g = dist.group.WORLD
        assert cwd.transport(g, torch.device("meta")) == "fake"
        out = cw.chain_all_gather(torch.empty(5, device="meta"), group=g)
        assert tuple(out.shape) == (4, 5)


# -- 4. run_cell -------------------------------------------------------------------------


RENAMED = {"lower_s": "build_s", "compile_s": "run_s", "hlo_flops_global": "counted_flops_global",
           "hlo_overlap": "op_overlap"}
JAX_KEYS = ("arch", "shape", "mesh", "collectives", "remat", "variant", "num_chains", "ar_algo",
            "compress_grads", "bucket_bytes", "topology", "src_read_bw", "status", "lower_s",
            "compile_s", "chips", "memory_analysis", "roofline", "model_flops_global",
            "hlo_flops_global", "useful_flops_ratio", "overlap_model", "hlo_overlap")


def test_run_cell_train_record(background):
    rec = background("run_cell")["train"]
    assert rec["status"] == "ok" and rec["cuda_initialized"] is False
    for key in JAX_KEYS:
        assert RENAMED.get(key, key) in rec, key
    assert rec["chips"] == 4 and rec["num_chains"] == "auto" and rec["bucket_bytes"] == 4 << 20
    roof = rec["roofline"]
    assert roof["collective_breakdown"]["collective-permute"] > 0  # the DP ring
    assert roof["collective_breakdown"]["all-reduce"] > 0  # the TP group's
    assert roof["flops_per_device"] * 4 == rec["counted_flops_global"]
    mem = rec["memory_analysis"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["alias_size_in_bytes"] > 0  # params and moments updated in place
    assert rec["op_overlap"]["collectives"] > 0 and rec["op_overlap"]["async_start"] > 0
    assert rec["overlap_model"]["total_wire_bytes"] > 0
    assert 0 < rec["useful_flops_ratio"] < 1


def test_run_cell_decode_record(background):
    out = background("run_cell")
    rec = out["decode"]
    assert rec["status"] == "ok" and rec["cuda_initialized"] is False
    assert rec["roofline"]["collective_bytes_per_device"] > 0
    assert "overlap_model" not in rec
    assert out["world_after"] is False
