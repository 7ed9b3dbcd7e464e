"""Op-level cost counter (FLOPs / device-memory bytes / collective
bytes / live memory) — the port's counterpart of
``repro.launch.hlo_cost``.

The JAX module parses the compiled HLO text; eager PyTorch has no
compiled module, so this one books every aten op as it dispatches
(:class:`OpCost`, a ``TorchDispatchMode``), forward and backward, in
program order. The JAX conventions map so:

* ``_FREE_OPS`` (parameter, constant, tuple, bitcast, ...) — view and
  alias ops (``OpOverload.is_view``, ``_unsafe_view``), ``detach``,
  ``lift_fresh`` (a tensor made from host data, HLO's ``constant``) and
  the ``empty*`` factories cost nothing.
* ``_dot_flops`` — ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` at
  2·M·N·K, the output's elements times twice the contraction; any
  ``_scaled_dot_product_*`` op as ``torch.utils.flop_counter`` prices
  it (on meta tensors attention runs in its math form: dots and a
  softmax).
* ``_conv_flops`` — ``convolution`` at 2·out·kernel_elems/kernel_out;
  ``convolution_backward`` as ``torch.utils.flop_counter`` prices it.
* ``_ELEMENTWISE_FLOPS`` — their aten counterparts (``add``, ``sub``,
  ``mul``, ``div``, ``pow``, ``exp``, ``sigmoid`` for ``logistic``,
  ``reciprocal`` for a divide, ...; in-place forms too) at 1 flop an
  output element.
* Collectives — the ``c10d`` ops under JAX's kinds by JAX's operand-byte
  rules (``_collective_result_bytes``): an all-gather counts its result
  divided by the group size, a reduce-scatter its result times the
  group size, an all-reduce or all-to-all its result; a ``send`` is a
  ``collective-permute``. A ``recv`` and a ``Work.wait()`` are not
  counted, as an async ``-done`` is not.
* Bytes — eager mode has no fusion, so ``bytes`` (the upper bound) is
  the operand plus result bytes of every op that is not free, and
  ``bytes_lb`` the operand plus result bytes of dots, convolutions and
  collectives and the result bytes alone of every other op (JAX's
  ``fused=False`` rule: each buffer written once).
* ``while`` trip counts — none: eager dispatch books every iteration of
  a Python loop, which is what the trip-count scaling recovers in HLO.
* ``op_name`` metadata — each record's path: the ``nn.Module`` path
  from ``torch.utils.module_tracker.ModuleTracker`` where a module is
  running; the port's models are functions over parameter trees, so
  there the path is the chain of ``repro_torch`` functions on the
  Python stack (``transformer.loss_fn/transformer.body/...``), and
  an op that autograd's backward dispatches adds its node
  (``/MmBackward0``).
* ``memory_analysis()`` — live bytes tracked by storage (each storage
  once: views share one) on the analysed device, from the arguments'
  bytes up; the keys of the JAX dry run's ``_mem_dict``.
* ``constant_bytes`` — the bytes of tensors the run makes from host
  data (``torch.tensor``/``torch.as_tensor`` of Python data: the
  executors' index tables), the counterpart of HLO ``constant``
  literals.

Nothing here allocates on a device of its own: run the function on meta
tensors to count a full-width cell.
"""

from __future__ import annotations

import dataclasses
import re
import sys
import weakref
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# free: metadata or aliasing only (HLO's parameter/bitcast/tuple/constant)
_FREE = {
    "detach", "alias", "lift_fresh", "_unsafe_view", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "empty_permuted",
}

# 2·M·N·K: the operand whose last dim is contracted, by position
_DOT_LHS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}

# aten name -> the HLO elementwise opcode it stands for (1 flop / element)
_ELEMENTWISE = {
    "add": "add", "sub": "subtract", "rsub": "subtract", "mul": "multiply",
    "div": "divide", "reciprocal": "divide", "pow": "power", "maximum": "maximum",
    "minimum": "minimum", "exp": "exponential", "expm1": "exponential-minus-one",
    "log": "log", "log1p": "log-plus-one", "tanh": "tanh", "sigmoid": "logistic",
    "rsqrt": "rsqrt", "sqrt": "sqrt", "sin": "sine", "cos": "cosine", "neg": "negate",
    "abs": "abs", "atan2": "atan2", "remainder": "remainder", "fmod": "remainder",
    "erf": "erf",
}

# c10d op -> JAX collective kind; the operand-byte rule is applied by kind
_C10D = {
    "allreduce_": "all-reduce", "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "send": "collective-permute",
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0  # upper bound: operand + result bytes of every op
    bytes_lb: float = 0.0  # lower bound: results, plus dot/conv/collective operands
    coll: dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS}
    )

    def __iadd__(self, other: "Cost") -> "Cost":
        self.flops += other.flops
        self.bytes += other.bytes
        self.bytes_lb += other.bytes_lb
        for k in self.coll:
            self.coll[k] += other.coll[k]
        return self

    def scaled(self, n: float) -> "Cost":
        return Cost(
            self.flops * n, self.bytes * n, self.bytes_lb * n,
            {k: v * n for k, v in self.coll.items()},
        )

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One booked op: its aten name, first result shape, path and cost;
    ``kind`` is its collective kind (``None`` for any other op)."""

    op: str
    shape: tuple[int, ...]
    path: str
    flops: float
    bytes: float
    bytes_lb: float
    kind: str | None = None


@dataclasses.dataclass(frozen=True)
class Wait:
    """A ``Work.wait()`` on the work of record ``index``, at its place
    in the trace."""

    index: int


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().name() == "ProcessGroup":
            return int(dist.ProcessGroup.unbox(a).size())
    return 1


def _dot_flops(name: str, args, out) -> float:
    return 2.0 * _numel(out.shape) * int(args[_DOT_LHS[name]].shape[-1])


def _conv_flops(args, out) -> float:
    weight, transposed = args[1], bool(args[6])
    kernel_out = weight.shape[1] * int(args[8]) if transposed else weight.shape[0]
    return 2.0 * _numel(out.shape) * weight.numel() / max(1, int(kernel_out))


def _collective_bytes(kind: str, args, group: int) -> int:
    """Wire bytes of one c10d op by JAX's operand rules, from its first
    argument: a send's payload, every other collective's results."""
    result = sum(_nbytes(t) for t in _tensors(args[0], []))
    if kind == "all-gather":
        return result // group
    if kind == "reduce-scatter":
        return result * group
    return result


_LAYER_INDEX = re.compile(r"\.\d+(?=\.|/|$)")


def _stack_path(skip: int) -> str:
    """The chain of ``repro_torch`` functions on the Python stack,
    outermost first (``module.function``)."""
    f = sys._getframe(skip)
    names = []
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and mod != __name__:
            names.append(f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}")
        f = f.f_back
    return "/".join(reversed(names))


class _Constants(TorchFunctionMode):
    """Catches tensors made from Python data (``torch.tensor``,
    ``torch.as_tensor`` of non-tensors), which never dispatch an aten op
    when made on the target device."""

    def __init__(self, owner: "OpCost") -> None:
        super().__init__()
        self.owner = owner

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func is torch.tensor or func is torch.as_tensor) and args \
                and not isinstance(args[0], torch.Tensor) and isinstance(out, torch.Tensor):
            self.owner.constant_bytes += _nbytes(out)
            self.owner._track(out)
        return out


class OpCost(TorchDispatchMode):
    """Books every aten op dispatched inside the block (see the module
    docstring): ``cost`` (a :class:`Cost`), ``records`` (one
    :class:`OpRecord` per op that is not free, in program order),
    ``trace`` (the records with a :class:`Wait` where a collective's work
    was waited on), ``constant_bytes``, ``flop_counter_flops`` (the count
    ``torch.utils.flop_counter.FlopCounterMode`` makes of the same pass:
    its registry's formula on every op it prices, applied here to each
    op as it dispatches, without a second dispatch mode) and the
    live-memory tracker (:meth:`memory_analysis`).

    The tracked memory is the device of :meth:`run`'s first argument
    (else of the first op's result). ``paths=False`` skips the per-op
    path (faster)."""

    def __init__(self, *, paths: bool = True) -> None:
        super().__init__()
        self.device = None
        self.paths = paths
        self.cost = Cost()
        self.records: list[OpRecord] = []
        self.trace: list[OpRecord | Wait] = []
        self.constant_bytes = 0
        self.flop_counter_flops = 0.0
        self._live: dict[int, int] = {}
        self._refs: dict[int, Any] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self._arg_keys: set[int] = set()
        self._works: dict[int, tuple[Any, int]] = {}
        self._patched: dict[type, Callable] = {}
        self._tracker = None
        self._constants = _Constants(self)

    # -- entering and leaving ------------------------------------------------

    def __enter__(self):
        from torch.utils.module_tracker import ModuleTracker

        self._tracker = ModuleTracker().__enter__()
        self._constants.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._constants.__exit__(*exc)
        self._tracker.__exit__(*exc)
        for cls, orig in self._patched.items():
            cls.wait = orig
        self._patched.clear()
        self._works.clear()
        return out

    def run(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` inside the mode, with the arguments'
        storages counted as the live bytes it starts from and its
        outputs' as ``output_bytes``. Returns what ``fn`` returns."""
        arg_tensors = _tensors((args, kwargs), [])
        if self.device is None and arg_tensors:
            self.device = arg_tensors[0].device
        for t in arg_tensors:
            key = self._track(t)
            if key is not None:
                self._arg_keys.add(key)
        self.argument_bytes = self.live_bytes
        with self:
            out = fn(*args, **kwargs)
        seen = set()
        for t in _tensors(out, []):
            key = self._key(t)
            if key is None or key in seen:
                continue
            seen.add(key)
            n = t.untyped_storage().nbytes()
            self.output_bytes += n
            if key in self._arg_keys:
                self.alias_bytes += n
        return out

    # -- memory --------------------------------------------------------------

    def _key(self, t: torch.Tensor) -> int | None:
        if self.device is None:
            self.device = t.device
        if t.device != self.device:
            return None
        return StorageWeakRef(t.untyped_storage()).cdata

    def _track(self, t: torch.Tensor) -> int | None:
        key = self._key(t)
        if key is None or key in self._live:
            return key
        st = t.untyped_storage()
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
        return key

    def _free(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self._refs.pop(key, None)
        self.live_bytes -= n

    def memory_analysis(self) -> dict[str, int]:
        """The JAX dry run's ``_mem_dict`` keys from the tracker: the
        arguments' and outputs' bytes (each storage once), the outputs'
        bytes that alias arguments (donated state updated in place), the
        peak of the live bytes and the peak less the arguments."""
        return {
            "temp_size_in_bytes": int(self.peak_bytes - self.argument_bytes),
            "argument_size_in_bytes": int(self.argument_bytes),
            "output_size_in_bytes": int(self.output_bytes),
            "alias_size_in_bytes": int(self.alias_bytes),
            "peak_memory_in_bytes": int(self.peak_bytes),
        }

    # -- async works ---------------------------------------------------------

    def _watch(self, work_obj, index: int) -> None:
        """Note the work of record ``index`` so that its ``wait()`` lands
        in the trace (the pybind wrapper is kept, so the caller's work is
        this same object)."""
        try:
            work = dist.Work.unbox(work_obj)
        except Exception:
            return
        self._works[id(work)] = (work, index)
        cls = type(work)
        if cls in self._patched:
            return
        orig = cls.wait
        self._patched[cls] = orig
        works, trace = self._works, self.trace

        def wait(w, *a, **k):
            hit = works.pop(id(w), None)
            if hit is not None:
                trace.append(Wait(hit[1]))
            return orig(w, *a, **k)

        cls.wait = wait

    # -- booking -------------------------------------------------------------

    def _path(self) -> str:
        mods = [p for p in self._tracker.parents if p != "Global"]
        path = max(mods, key=len) if mods else _stack_path(2)
        node = torch._C._current_autograd_node()
        if node is not None:
            path = f"{path}/{node.name()}"
        return _LAYER_INDEX.sub("", path)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        outs = _tensors(out, [])
        for t in outs:
            self._track(t)
        if func.namespace == "c10d":
            return self._c10d(name, args, out)
        if name in _FREE or func.is_view:
            return out
        priced = flop_registry.get(func.overloadpacket)
        raw = float(priced(*args, **kwargs, out_val=out)) if priced is not None else 0.0
        self.flop_counter_flops += raw
        base = name[:-1] if name.endswith("_") and not name.startswith("_") else name
        flops = 0.0
        heavy = False
        if base in _DOT_LHS and outs:
            flops, heavy = _dot_flops(base, args, outs[0]), True
        elif base == "convolution":
            flops, heavy = _conv_flops(args, outs[0]), True
        elif base == "convolution_backward" or base.startswith("_scaled_dot_product"):
            flops, heavy = raw, True
        elif base in _ELEMENTWISE:
            flops = float(sum(t.numel() for t in outs))
        result = sum(_nbytes(t) for t in outs)
        operands = sum(_nbytes(t) for t in _tensors((args, kwargs), []))
        b = operands + result
        lb = b if heavy else result
        c = self.cost
        c.flops += flops
        c.bytes += b
        c.bytes_lb += lb
        self._book(OpRecord(name, tuple(outs[0].shape) if outs else (),
                            self._path() if self.paths else "", flops, b, lb))
        return out

    def _c10d(self, name: str, args, out):
        """Book a c10d op: a collective under its kind (its operand and
        result bytes, in place for an all-reduce: both are its tensors),
        a ``recv`` as the bytes it writes, anything else not at all."""
        kind = _C10D.get(name)
        tensors = _tensors(args, [])
        first = tuple(tensors[0].shape) if tensors else ()
        path = self._path() if self.paths else ""
        if kind is None:
            if name.startswith("recv"):
                b = sum(_nbytes(t) for t in tensors)
                self.cost.bytes += b
                self.cost.bytes_lb += b
                self._book(OpRecord(name, first, path, 0.0, b, b))
            return out
        b = sum(_nbytes(t) for t in tensors)
        if name.startswith("allreduce"):
            b *= 2
        wire = _collective_bytes(kind, args, _group_size(args))
        c = self.cost
        c.coll[kind] += wire
        c.bytes += b
        c.bytes_lb += b
        self._book(OpRecord(name, first, path, 0.0, b, b, kind))
        work = out if isinstance(out, torch.ScriptObject) else (
            out[-1] if isinstance(out, tuple) and out
            and isinstance(out[-1], torch.ScriptObject) else None)
        if work is not None:
            self._watch(work, len(self.records) - 1)
        return out

    def _book(self, rec: OpRecord) -> None:
        self.records.append(rec)
        self.trace.append(rec)


def analyze(fn: Callable, *args, **kwargs) -> Cost:
    """The cost of ``fn(*args, **kwargs)``, every op it dispatches booked
    once (forward and backward, each loop iteration)."""
    oc = OpCost(paths=False)
    oc.run(fn, *args, **kwargs)
    return oc.cost


def constant_bytes(fn: Callable, *args, **kwargs) -> int:
    """The bytes of the tensors ``fn`` makes from host data (the
    executors' index tables): the counterpart of the HLO module's
    ``constant`` literals."""
    oc = OpCost(paths=False)
    oc.run(fn, *args, **kwargs)
    return oc.constant_bytes


__all__ = ["COLLECTIVE_KINDS", "Cost", "OpCost", "OpRecord", "Wait", "analyze",
           "constant_bytes"]
