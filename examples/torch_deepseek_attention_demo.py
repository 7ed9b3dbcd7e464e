"""The paper's §IV-E workload, end to end on PyTorch: DeepSeek-V3
self-attention data movement (Table II, P1–P3 / D1–D3) through the
Torrent stack.

The PyTorch twin of ``examples/deepseek_attention_demo.py``. For each
workload this script
  * runs the DSE layout transform through the relayout kernel (the CUDA
    kernel on the card, its plain twin on the CPU) and checks it bit for
    bit against the oracle on the same device,
  * multicasts the transformed operand to the 8 follower clusters with
    a four-phase ChainTask over the 3×3 FPGA-SoC topology,
  * reports predicted cycles vs the XDMA unicast baseline.

The script runs on the card and raises without one unless
``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_deepseek_attention_demo.py
"""

import argparse
import dataclasses

import torch

from repro_torch.core import ChainTask, MeshTopology
from repro_torch.core.simulator import unicast_latency
from repro_torch.device import resolve_device
from repro_torch.kernels.relayout import ops as relayout

# Table II and the XDMA baseline, as ``benchmarks/bench_fig9_deepseek.py``
# defines them
TOPO = MeshTopology(3, 3)  # the paper's 9-cluster VPK180 FPGA SoC
ALL_DSTS = list(range(1, 9))


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    rows: int
    cols: int
    src_layout: str
    dst_layout: str
    multicast: bool


WORKLOADS = [
    Workload("P1:QKT_Single_Head", 2048, 192, "MNM16N8", "MNM8N8", True),
    Workload("P2:SV_Single_Head", 2048, 128, "MNM16N8", "MNM8N8", True),
    Workload("P3:KV_Matrix_MLA_Recovery", 2048, 512, "MNM16N8", "MNM16N8", True),
    Workload("D1:QKT_Single_Head", 4096, 192, "MNM16N8", "MNM64N16", False),
    Workload("D2:SV_Single_Head", 4096, 128, "MNM16N8", "MNM64N16", False),
    Workload("D3:KV_Matrix_MLA_Recovery", 4096, 512, "MNM16N8", "MNM16N8", True),
]

BYTES_PER_EL = 1  # the paper's GeMM is 8-bit


def xdma_latency(w: Workload) -> int:
    """Baseline: per-destination sequential P2P copies (layout
    transform is on-the-fly in XDMA's DSE, same as Torrent's)."""
    size = w.rows * w.cols * BYTES_PER_EL
    dsts = ALL_DSTS if w.multicast else [1]
    return unicast_latency(TOPO, 0, dsts, size)


def dense_int8(rows: int, cols: int, device) -> torch.Tensor:
    """``arange(rows * cols)`` in int8, wrapping as numpy's does: built
    as ``arange % 256`` reinterpreted as int8, so the values never
    depend on how a device's arange wraps."""
    n = torch.arange(rows * cols, dtype=torch.int32, device=device) % 256
    return n.to(torch.uint8).view(torch.int8).reshape(rows, cols)


def run_workload(w: Workload, device) -> dict:
    """Relayout ``w``'s operand on ``device`` and multicast it; returns
    the relayout's result, its check and the two cycle counts."""
    shape = (w.rows, w.cols)
    src = relayout.parse_layout(w.src_layout)
    dst = relayout.parse_layout(w.dst_layout)

    # 1. DSE layout transform (relayout kernel vs oracle)
    blocked = relayout.dense_to_blocked(dense_int8(w.rows, w.cols, device), src)
    out = relayout.relayout(blocked, shape, src, dst)
    ok = torch.equal(out, relayout.relayout_ref(blocked, shape, src, dst))

    # 2. P2MP movement: Chainwrite vs XDMA unicast
    dests = ALL_DSTS if w.multicast else [1]
    task = ChainTask(TOPO, 0, dests, out.reshape(-1), scheduler="tsp")
    task.run()
    cw = task.cycle_ledger["total"]
    base = xdma_latency(w)
    return {"relayout": out, "relayout_ok": ok, "ndst": len(dests),
            "xdma_cc": base, "chainwrite_cc": cw, "speedup": base / cw}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    results = []
    for w in WORKLOADS:
        r = run_workload(w, device)
        print(
            f"{w.name:28s} {w.rows}x{w.cols} {w.src_layout}->{w.dst_layout} "
            f"relayout_ok={r['relayout_ok']} ndst={r['ndst']} "
            f"xdma={r['xdma_cc']}cc chainwrite={r['chainwrite_cc']}cc "
            f"speedup={r['speedup']:.2f}x"
        )
        results.append(r)
    return results


if __name__ == "__main__":
    main()
