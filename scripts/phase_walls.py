"""Run the examples phase of ``chip_smoke.py`` alone, a spawn of two
gloo ranks that do nothing, and the dist and tp families phases, each
followed by its wall seconds: what a spawn costs beside the phases that
spawn ranks. Needs one card:

    python3 scripts/phase_walls.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def noop(rank, world, device):
    import torch
    torch.zeros(1, device=device).sum().item()
    return rank


if __name__ == "__main__":
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.dist import spawn

    print(cs.smi_line(), flush=True)
    t = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t:.2f}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, fn in (("examples", cs.examples_phase), ("noop spawn", None),
                     ("dist", cs.dist_phase), ("tp families", cs.tp_families_phase)):
        t = time.perf_counter()
        if fn is None:
            spawn(noop, 2, backend="gloo", device="cuda", timeout_s=300)
        else:
            fn()
        print(f"wall {name}: {time.perf_counter() - t:.2f}", flush=True)
