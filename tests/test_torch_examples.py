"""The examples' PyTorch twins (``examples/torch_*.py``) against the JAX
examples on the CPU.

Every example file is loaded by path. ``examples/chainwrite_collectives.py``
is never imported (it rewrites ``XLA_FLAGS`` when imported): its section
0 is run from its own source, and its sections 1–3 are held in this
process against what the example asserts and prints, through
``repro.core``'s planners and IR byte model. The other JAX examples run
with a recording stand-in for their ``Server``/``Trainer``, so the test
reads what they computed: the server in a subprocess started with the
module (beside the twins' fresh-import check), the trainers in this
process. The module spawns no ``torch.distributed`` ranks.

Tolerances: the training runs start from the JAX trainer's params and
agree within 5e-3 per step, ``tests/test_torch_train.py``'s Trainer
tolerance (bf16 rounding in different places); the server's greedy
tokens are equal or differ where JAX had a tie
(``tests/_serve_cases.py``); everything else is exact.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import math
import os
import pickle
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as JTrain  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.core import ChainTask as JChainTask  # noqa: E402
from repro.core import program as jprg  # noqa: E402
from repro.core.scheduling import tsp_schedule as jtsp  # noqa: E402
from repro.core.topology import MeshTopology as JMesh  # noqa: E402
from repro.data.pipeline import MarkovSource as JMarkovSource  # noqa: E402
from repro.kernels.relayout import ops as JR  # noqa: E402
from repro_torch.kernels.relayout import ops as TR  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

import _example_pins as PINS  # noqa: E402
from _serve_cases import check_tokens  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
TWINS = ("quickstart", "serve_batch", "train_lm", "chainwrite_collectives",
         "deepseek_attention_demo")
TRAIN_LOSS_TOL = 5e-3


def _load(name: str):
    """Import ``examples/<name>.py`` by path (as ``_example_<name>``)."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them
    several times faster than a pool contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the JAX example's server, run in a subprocess beside this module's
# other tests (its ~15 s of jit compiles would otherwise add to theirs):
# records what the recording Server saw, and its params, in a pickle
_JAX_SERVE = """
import importlib.util, pickle, sys
import jax
from repro.launch.serve import Server
spec = importlib.util.spec_from_file_location("serve_batch", {example!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
box = {{}}

class Recording(Server):
    def __init__(self, sc):
        super().__init__(sc)
        box["server"] = self

    def register_prefix(self, tokens):
        box["entry"] = super().register_prefix(tokens)
        return box["entry"]

    def run(self, requests):
        box["requests"], box["out"] = requests, super().run(requests)
        return box["out"]

mod.Server = Recording
sys.argv = ["serve_batch.py", *{argv!r}]
mod.main()
entry = box["entry"]
with open({out!r}, "wb") as f:
    pickle.dump({{"params": jax.device_get(box["server"].params),
                 "max_seq": box["server"].sc.max_seq, "kv": entry.broadcast,
                 "plen": entry.plen, "pages": entry.paged.shape[0], "run": box["out"],
                 "requests": [dict(rid=r.rid, prompt=r.prompt, out=r.out,
                                   prefix_hit=r.prefix_hit) for r in box["requests"]]}}, f)
"""
SERVE_ARGV = ["--requests", "4", "--max-new", "4"]

# importing the five twins in a fresh interpreter
_IMPORTS = """
import importlib.util, sys
for name in {names!r}:
    spec = importlib.util.spec_from_file_location(name, {root!r} + "/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
assert not bad, bad
assert "repro_torch" in sys.modules
"""


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """Start the module's two subprocesses at once, before its first
    test: the JAX serve example and the twins' fresh import. A test
    reads one with :func:`_finish`; teardown ends any left running."""
    root = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=str(EXAMPLES.parent / "src"))
    serve_out = str(root / "jax_serve.pkl")
    procs = {
        "serve": subprocess.Popen(
            [sys.executable, "-c", _JAX_SERVE.format(
                example=str(EXAMPLES / "serve_batch.py"), argv=SERVE_ARGV, out=serve_out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
        "imports": subprocess.Popen(
            [sys.executable, "-c", _IMPORTS.format(
                names=[f"torch_{n}" for n in TWINS], root=str(EXAMPLES))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
    }
    yield {"procs": procs, "serve_out": serve_out}
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _finish(background, name: str) -> str:
    """Wait for subprocess ``name``; its stdout, or a failure with its stderr."""
    out, err = background["procs"][name].communicate(timeout=600)
    assert background["procs"][name].returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def twin():
    mods = {}

    def get(name):
        if name not in mods:
            mods[name] = _load(f"torch_{name}")
        return mods[name]

    return get


def _losses_close(got, want):
    assert len(got) == len(want)
    assert all(math.isfinite(x) for x in got)
    assert max(abs(a - b) for a, b in zip(got, want)) < TRAIN_LOSS_TOL, (got, want)


# -- quickstart ----------------------------------------------------------------

def test_quickstart_sections_1_2_print_what_jax_prints(twin, capsys, monkeypatch):
    """Sections 1–2 print, line for line, what the JAX example's
    ``scheduling_demo``/``chaintask_demo`` print (section 3 stubbed),
    and return the pinned values."""
    jq = _load("quickstart")
    capsys.readouterr()
    jq.scheduling_demo()
    jq.chaintask_demo()
    want = capsys.readouterr().out

    tq = twin("quickstart")
    monkeypatch.setattr(tq, "training_demo", lambda device: {
        "first_loss": 0.0, "last_loss": 0.0, "final_step": 0, "tokens_per_s": 0.0})
    out = tq.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.split("\n=== 3.")[0] == want
    assert out["scheduling"] == PINS.QUICKSTART_SCHEDULING
    assert out["chaintask"] == PINS.QUICKSTART_CHAINTASK


def test_quickstart_training_config_and_short_run_match_jax(twin, monkeypatch, tmp_path):
    """Section 3's TrainConfig is the JAX example's field for field but
    the checkpoint directory (a port-named one under the temp dir); 3
    steps from the JAX trainer's params give its losses within
    ``TRAIN_LOSS_TOL``."""
    jq = _load("quickstart")
    seen = []

    class Recording:
        def __init__(self, tc):
            seen.append(tc)

        def run(self):
            return {"first_loss": 0.0, "last_loss": 0.0, "final_step": 0, "tokens_per_s": 0.0}

    monkeypatch.setattr(JTrain, "Trainer", Recording)
    jq.training_demo()
    monkeypatch.undo()
    (jtc,) = seen

    tq = twin("quickstart")
    ttc = tq.training_config(str(tmp_path / "port"))
    jax_fields = {f.name for f in dataclasses.fields(jtc)}
    for name in jax_fields - {"ckpt_dir"}:
        assert getattr(ttc, name) == getattr(jtc, name), name
    for f in dataclasses.fields(ttc):  # the port's own knobs at their defaults
        if f.name not in jax_fields:
            assert getattr(ttc, f.name) == f.default, f.name
    assert tq.training_config().ckpt_dir == tq.CKPT_DIR != jtc.ckpt_dir
    assert Path(tq.CKPT_DIR).parent == Path(tempfile.gettempdir())

    jtr = JTrain.Trainer(dataclasses.replace(jtc, steps=3, ckpt_dir=str(tmp_path / "jax")))
    params = jax.device_get(jtr.state["params"])
    jout = jtr.run()
    tout = tq.training_demo("cpu", dataclasses.replace(ttc, steps=3), params=params)
    assert tout["final_step"] == jout["final_step"] == 3
    _losses_close(tout["losses"], jout["losses"])


# -- serve_batch ---------------------------------------------------------------

def test_serve_batch_matches_jax_with_carried_weights(twin, background):
    """``--requests 4 --max-new 4``: the JAX example's server, recorded
    (in the background subprocess), and the twin's with the JAX weights
    carried in give the same KV and weight multicast records, pages, hit
    rate, latency ticks, decode steps and tokens (or a JAX tie)."""
    _finish(background, "serve")
    with open(background["serve_out"], "rb") as f:
        j = pickle.load(f)

    ts_mod = twin("serve_batch")
    server = ts_mod.make_server(ts_mod.parse_args([*SERVE_ARGV, "--device", "cpu"]))
    assert server.sc.max_seq == j["max_seq"]
    server.broadcast_weights(new_params=params_from_numpy(j["params"], "cpu"))
    res = ts_mod.serve(server, 4, 4)
    assert res["kv"] == j["kv"] == PINS.SERVE_KV
    assert res["pages"] == j["pages"] == PINS.SERVE_PAGES
    for key in ("requests", "served", "generated_tokens", "decode_steps", "prefix_hit_rate",
                "prefix_entries", "prefix_bytes", "latency_ticks_p50", "latency_ticks_p99",
                "weight_multicast", "kv_multicast"):
        assert res["run"][key] == j["run"][key], key
    assert [r.prefix_hit for r in res["requests"]] == [True, False, True, False]
    jserver = types.SimpleNamespace(cfg=JC.get_smoke_config("yi-6b"), params=j["params"],
                                    sc=types.SimpleNamespace(max_seq=j["max_seq"]))
    check_tokens(jserver, [types.SimpleNamespace(**r) for r in j["requests"]],
                 res["requests"], j["plen"])


def test_serve_batch_defaults_give_the_pinned_records(twin, capsys):
    """``main`` at the defaults (12 requests, 16 new tokens): the records
    and schedule ``chip_smoke.py`` holds the card to, printed in the JAX
    example's words with the device's name."""
    res = twin("serve_batch").main(["--device", "cpu"])
    out = res["run"]
    assert res["kv"] == PINS.SERVE_KV and res["pages"] == PINS.SERVE_PAGES
    assert {k: out[k] for k in PINS.SERVE_RUN} == PINS.SERVE_RUN
    text = capsys.readouterr().out
    assert "tok/s on cpu); prefix-cache hit rate 50%, p50/p99 latency 30/45 ticks" in text
    assert "weight multicast to 7 replicas: 427264 bytes, 6981 predicted cycles, 6.71x" in text


# -- train_lm --------------------------------------------------------------------

def test_train_lm_matches_the_jax_rebuilt_trainer(twin, monkeypatch, capsys, tmp_path):
    """``--layers 1 --steps 3``: the JAX example's trainer, rebuilt at
    one layer by its own override code and recorded, and the twin's
    from its params: the same config, parameter count, header line and
    losses within ``TRAIN_LOSS_TOL``."""
    jl = _load("train_lm")
    box = {}

    class Recording(JTrain.Trainer):
        def run(self):
            box["cfg"], box["params"] = self.cfg, jax.device_get(self.state["params"])
            box["out"] = super().run()
            return box["out"]

    monkeypatch.setattr(jl, "Trainer", Recording)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--layers", "1", "--steps", "3",
                                      "--ckpt-dir", str(tmp_path / "jax")])
    capsys.readouterr()
    jl.main()
    jheader = capsys.readouterr().out.splitlines()[0]

    tl = twin("train_lm")
    args = tl.parse_args(["--layers", "1", "--steps", "3", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path / "port")])
    trainer = tl.build_trainer(args, params=box["params"])
    assert dataclasses.asdict(trainer.cfg) == dataclasses.asdict(box["cfg"])
    n = tl.param_count(trainer)
    assert n == sum(x.size for x in jax.tree.leaves(box["params"]))
    assert jheader == f"training yi-6b-smoke: {n/1e6:.1f}M params, 3 steps, collectives=xla"
    out = trainer.run()
    assert out["restarts"] == box["out"]["restarts"] == 0
    _losses_close(out["losses"], box["out"]["losses"])


def test_train_lm_overrides_match_the_jax_example(twin, monkeypatch):
    """``--dim 32 --layers 3 --vocab 512``: the twin's model config is the
    one the JAX example's override code builds (run against a stand-in
    Trainer that trains nothing)."""
    jl = _load("train_lm")
    box = {}

    class Stub:
        def __init__(self, tc):
            self.cfg = JC.get_smoke_config(tc.arch)
            self.source = JMarkovSource(self.cfg.vocab_size, tc.seq_len, tc.global_batch)
            self.state = {"params": {}}

        def _build(self):
            box["cfg"] = self.cfg

        def run(self):
            return {"first_loss": 0.0, "last_loss": 0.0, "restarts": 0,
                    "straggler_events": 0, "tokens_per_s": 0.0}

    argv = ["--dim", "32", "--layers", "3", "--vocab", "512"]
    monkeypatch.setattr(jl, "Trainer", Stub)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv])
    jl.main()
    cfg = twin("train_lm").model_config(twin("train_lm").parse_args(argv))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(box["cfg"])
    assert (cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.num_layers, cfg.vocab_size) == (
        32, 128, 8, 3, 512)


def test_train_lm_vocab_override_trains_where_the_jax_source_fails(twin, tmp_path):
    """The JAX example sets ``trainer.source.vocab`` after its Markov
    table was drawn at the config's vocabulary (``examples/train_lm.py``):
    the first batch then indexes the table out of range. The twin builds
    its source at the overridden vocabulary, so ``--vocab 512`` trains."""
    small = JC.get_smoke_config("yi-6b").vocab_size
    source = JMarkovSource(vocab=small, seq_len=64, global_batch=8, seed=1)
    source.vocab = 512  # what the JAX example does to its trainer's source
    with pytest.raises(IndexError):
        source.batch(0)

    tl = twin("train_lm")
    trainer = tl.build_trainer(tl.parse_args(["--vocab", "512", "--steps", "2", "--device",
                                              "cpu", "--ckpt-dir", str(tmp_path)]))
    assert trainer.cfg.vocab_size == trainer.source.vocab == 512 > small
    assert trainer.source.table.shape == (512, trainer.source.branch)
    out = trainer.run()
    assert out["final_step"] == 2 and all(math.isfinite(x) for x in out["losses"])


# -- chainwrite_collectives ------------------------------------------------------

def test_chainwrite_section_0_prints_the_jax_lines(twin, capsys):
    """Section 0 is pure ``core``: its lines equal the JAX example's,
    run from the example's own source (``show_programs``)."""
    tree = ast.parse((EXAMPLES / "chainwrite_collectives.py").read_text())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "show_programs"]
    ns = {"MeshTopology": JMesh}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "chainwrite_collectives.py", "exec"), ns)
    capsys.readouterr()
    ns["show_programs"]()
    want = capsys.readouterr().out
    assert "".join(line + "\n" for line in twin("chainwrite_collectives").show_programs()) == want


def test_chainwrite_sections_1_3_give_the_jax_values(twin):
    """In this process, against ``repro.core``: the broadcast's chain
    order is JAX's schedule and the per-device means are the values the
    JAX example asserts; the all-reduce's mean is the sum of the device
    ids; the executor's wire bytes a device are JAX's 448, the IR's
    ``program_wire_bytes`` of the ring all-reduce."""
    tc = twin("chainwrite_collectives")
    b = tc.broadcast_subset("cpu")
    order = (1, *jtsp(JMesh(4, 2), [3, 5, 6], source=1))
    assert b["order"] == order == PINS.CHAINWRITE_ORDER
    assert b["means"] == {d: 1.0 if d in order else 0.0 for d in range(8)} == PINS.CHAINWRITE_MEANS
    r = tc.ring_all_reduce("cpu")
    ring = (0, *jtsp(JMesh(8, 1), list(range(1, 8)), 0))
    assert r["ring"] == ring
    assert r["mean"] == r["expected"] == float(sum(range(8))) == PINS.CHAINWRITE_SUM_MEAN
    w = tc.wire_bytes("cpu")
    jbytes = jprg.program_wire_bytes(jprg.plan_all_reduce(8, (ring,)), 16 * 4 * 4)
    assert w["bytes_per_device"] == jbytes == w["ring_optimum"] == PINS.CHAINWRITE_WIRE_BYTES


# -- deepseek_attention_demo ------------------------------------------------------

def test_deepseek_demo_relayouts_and_cycles_match_jax(twin, capsys):
    """Each Table II workload: the twin's relayout equals JAX's
    ``relayout_ref`` of JAX's int8 ``arange`` bit for bit, its XDMA and
    Chainwrite cycles equal the benchmark's and JAX's ChainTask's (the
    JAX demo's printed integers for P3, D1, D2, D3), and the card's
    route is the pinned one."""
    from benchmarks.bench_fig9_deepseek import WORKLOADS, xdma_latency

    td = twin("deepseek_attention_demo")
    assert [dataclasses.astuple(w) for w in td.WORKLOADS] == [
        dataclasses.astuple(w) for w in WORKLOADS]
    results = td.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    for w, r, (name, xdma, chain, route), line in zip(WORKLOADS, results, PINS.DEEPSEEK, lines):
        shape = (w.rows, w.cols)
        src, dst = JR.parse_layout(w.src_layout), JR.parse_layout(w.dst_layout)
        dense = jnp.arange(w.rows * w.cols, dtype=jnp.int8).reshape(shape)
        np.testing.assert_array_equal(
            td.dense_int8(w.rows, w.cols, "cpu").numpy(), np.asarray(dense))
        want = np.asarray(JR.relayout_ref(JR.dense_to_blocked(dense, src), shape, src, dst))
        got = r["relayout"]
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert np.array_equal(got.numpy().view(np.uint8), want.view(np.uint8)), w.name
        assert r["relayout_ok"] and w.name == name
        task = JChainTask(JMesh(3, 3), 0, list(range(1, 9)) if w.multicast else [1],
                          want.reshape(-1), scheduler="tsp")
        task.run()
        assert (r["xdma_cc"], r["chainwrite_cc"]) == (
            xdma_latency(w), task.cycle_ledger["total"]) == (xdma, chain)
        assert TR._route(shape, TR.parse_layout(w.src_layout), TR.parse_layout(w.dst_layout),
                         1, 0, 0) == route
        assert line.startswith(f"{w.name:28s} {w.rows}x{w.cols} ") and (
            f"xdma={xdma}cc chainwrite={chain}cc speedup={xdma / chain:.2f}x" in line)
    assert {n: (x, c) for n, x, c, _ in PINS.DEEPSEEK if n[:2] in ("P3", "D1", "D2", "D3")} == {
        "P3:KV_Matrix_MLA_Recovery": (131186, 17080), "D1:QKT_Single_Head": (12301, 12407),
        "D2:SV_Single_Head": (8205, 8311), "D3:KV_Matrix_MLA_Recovery": (262258, 33464)}


# -- every twin ----------------------------------------------------------------------

def test_twins_import_no_jax_and_nothing_of_the_jax_package(background):
    """Importing the five twins in a fresh interpreter loads no ``jax``,
    no ``repro`` module and no ``benchmarks`` module."""
    _finish(background, "imports")


@pytest.mark.parametrize("name", TWINS)
def test_twin_main_defaults_to_the_card(twin, name):
    """Without ``--device`` each twin asks for the card and raises where
    there is none: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        twin(name).main([])
