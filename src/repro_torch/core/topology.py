"""Weighted link-graph topology with XY (dimension-ordered) routing.

The planning/pricing stack sees a topology as a **weighted link graph**:
nodes joined by directed links, each link carrying
:class:`LinkAttrs` — ``{bandwidth, latency, tier}``. The link-graph
contract every consumer (``core.scheduling``, ``core.simulator``,
``core.program.tier_crossing_stats``) programs against is:

* ``link_attrs(link)``          — the attributes of one directed link;
* ``weighted_distance(a, b)``   — summed link *latency* along the route
  (the weighted hop cost schedulers minimize);
* ``path_min_bw(a, b)``         — the bottleneck link *bandwidth
  fraction* along the route (scales the data-phase bytes/cycle);
* ``path_tier_crossings(a, b)`` — how many tier>0 (slow, inter-pod)
  links the route traverses;
* ``pod_of(node)`` / ``num_pods`` — the tier-0 island a node belongs to.

:class:`MeshTopology` is the **uniform-weight constructor** of that
contract: a 2-D mesh (optionally wrap-around torus) where every link is
``LinkAttrs(bandwidth=1.0, latency=1, tier=0)``, so ``weighted_distance
== distance`` (Manhattan / torus-Manhattan), ``path_min_bw == 1.0`` and
``path_tier_crossings == 0`` — by construction, every pre-existing call
site and CC-exact pin (82 CC/destination Fig. 7 slope, collective
latency pins) is preserved unchanged.

:class:`TieredMeshTopology` is the 2-tier refinement: the same global
``nx × ny`` mesh tiled into ``pods_x × pods_y`` equal pods, with every
link that crosses a pod boundary priced at ``interpod_bw`` (fraction of
the intra-pod link bandwidth) and ``interpod_latency`` (router-latency
multiplier), ``tier=1``. This is the off-chip/on-chip split of real
deployments (fast NoC inside a pod, slow chip-to-chip between pods);
scheduling on it makes hierarchical collectives a *planning outcome*
(see ``core.simulator.choose_num_chains``).

:class:`LinkGraph` is the fully explicit form — arbitrary nodes, an
arbitrary weighted link set, Dijkstra shortest routes — used by the
property tests as the model the mesh classes must agree with
(``to_link_graph()`` exports any mesh into it).

Coordinates are ``(x, y)`` with ``node_id = y * nx + x`` (row-major by
rows of ``nx``), matching the paper's cluster numbering (C0 at origin).
Links are directed edges between adjacent nodes.

``parse_topology_spec`` / ``.spec()`` round-trip the CLI grammar shared
by ``launch.dryrun --topology``, ``launch.train`` and the benchmarks:
``"8x8"``, ``"8x8:torus"``, ``"pods=4x(4x4):interpod_bw=0.25"``,
``"16x1:pods=4x1:interpod_lat=4"`` and — relative to a known axis size
— ``"pods=4:interpod_bw=0.25"``.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import math
from typing import Iterator, Sequence

Coord = tuple[int, int]
Link = tuple[Coord, Coord]  # directed (src, dst), adjacent nodes


@dataclasses.dataclass(frozen=True)
class LinkAttrs:
    """Per-link weights of the link graph.

    ``bandwidth`` is a fraction of the NoC link bandwidth
    (``SimParams.link_bw``); ``latency`` multiplies the per-hop router
    latency (``SimParams.router_cc``); ``tier`` labels the link's level
    (0 = intra-pod NoC, >0 = slower inter-pod fabric). The defaults are
    the uniform link every :class:`MeshTopology` edge carries.
    """

    bandwidth: float = 1.0
    latency: int = 1
    tier: int = 0


UNIFORM_LINK = LinkAttrs()


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """A 2-D mesh (optionally wrap-around torus) with XY routing —
    the uniform-weight link graph (every link = :data:`UNIFORM_LINK`)."""

    nx: int
    ny: int
    torus: bool = False

    # -- node helpers -------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return self.nx * self.ny

    def coord(self, node_id: int) -> Coord:
        if not 0 <= node_id < self.num_nodes:
            raise ValueError(f"node {node_id} outside {self.nx}x{self.ny} mesh")
        return (node_id % self.nx, node_id // self.nx)

    def node_id(self, coord: Coord) -> int:
        x, y = coord
        if not (0 <= x < self.nx and 0 <= y < self.ny):
            raise ValueError(f"coord {coord} outside {self.nx}x{self.ny} mesh")
        return y * self.nx + x

    def nodes(self) -> Iterator[int]:
        return iter(range(self.num_nodes))

    # -- distance / routing -------------------------------------------
    def _axis_steps(self, a: int, b: int, n: int) -> list[int]:
        """Unit steps along one axis from a to b (shortest direction)."""
        if a == b:
            return []
        if not self.torus:
            step = 1 if b > a else -1
            return [step] * abs(b - a)
        fwd = (b - a) % n
        bwd = (a - b) % n
        if fwd <= bwd:
            return [1] * fwd
        return [-1] * bwd

    def distance(self, a: Coord | int, b: Coord | int) -> int:
        """Hop count of the XY route (Manhattan / torus-Manhattan)."""
        ca = self.coord(a) if isinstance(a, int) else a
        cb = self.coord(b) if isinstance(b, int) else b
        return len(self._axis_steps(ca[0], cb[0], self.nx)) + len(
            self._axis_steps(ca[1], cb[1], self.ny)
        )

    def xy_path(self, src: Coord | int, dst: Coord | int) -> list[Link]:
        """Directed links of the XY (X-first, then Y) route src -> dst."""
        cur = self.coord(src) if isinstance(src, int) else src
        dst_c = self.coord(dst) if isinstance(dst, int) else dst
        links: list[Link] = []
        for sx in self._axis_steps(cur[0], dst_c[0], self.nx):
            nxt = ((cur[0] + sx) % self.nx, cur[1])
            links.append((cur, nxt))
            cur = nxt
        for sy in self._axis_steps(cur[1], dst_c[1], self.ny):
            nxt = (cur[0], (cur[1] + sy) % self.ny)
            links.append((cur, nxt))
            cur = nxt
        return links

    def path_nodes(self, src: Coord | int, dst: Coord | int) -> list[Coord]:
        """Nodes visited on the XY route, inclusive of both endpoints."""
        src_c = self.coord(src) if isinstance(src, int) else src
        links = self.xy_path(src_c, dst)
        return [src_c] + [l[1] for l in links]

    # -- weighted link-graph contract ---------------------------------
    def link_attrs(self, link: Link) -> LinkAttrs:
        """Attributes of one directed link (uniform mesh: every link is
        :data:`UNIFORM_LINK`). Subclasses override this one hook; the
        path aggregates below derive from it."""
        del link
        return UNIFORM_LINK

    @property
    def num_pods(self) -> int:
        return 1

    def pod_of(self, node: Coord | int) -> int:
        """Tier-0 island (pod) a node belongs to. One pod here."""
        del node
        return 0

    def weighted_distance(self, a: Coord | int, b: Coord | int) -> int:
        """Summed link latency of the XY route — the weighted hop cost
        schedulers minimize. Uniform mesh: identical to ``distance``
        (every link latency is 1), so every pre-refactor ordering and
        cycle pin is reproduced by construction."""
        return self.distance(a, b)

    def path_min_bw(self, a: Coord | int, b: Coord | int) -> float:
        """Bottleneck link bandwidth fraction along the XY route
        (1.0 when ``a == b`` — no link to bottleneck on)."""
        del a, b
        return 1.0

    def path_tier_crossings(self, a: Coord | int, b: Coord | int) -> int:
        """Number of tier>0 links the XY route traverses."""
        del a, b
        return 0

    def to_link_graph(self) -> "LinkGraph":
        """Export as the explicit :class:`LinkGraph` (node-id links with
        this topology's ``link_attrs``) — the property-test oracle."""
        links: dict[tuple[int, int], LinkAttrs] = {}
        for n in self.nodes():
            c = self.coord(n)
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                x, y = c[0] + dx, c[1] + dy
                if self.torus:
                    x, y = x % self.nx, y % self.ny
                elif not (0 <= x < self.nx and 0 <= y < self.ny):
                    continue
                if (x, y) == c:  # degenerate wrap on a length-1 axis
                    continue
                m = self.node_id((x, y))
                links[(n, m)] = self.link_attrs((c, (x, y)))
        return LinkGraph(
            self.num_nodes,
            tuple((a, b, attrs) for (a, b), attrs in sorted(links.items())),
        )

    def spec(self) -> str:
        """Canonical spec string (inverse of :func:`parse_topology_spec`)."""
        return f"{self.nx}x{self.ny}" + (":torus" if self.torus else "")

    # -- multicast tree (network-layer baseline) ----------------------
    def multicast_tree_links(
        self, src: Coord | int, dsts: Sequence[Coord | int]
    ) -> set[Link]:
        """Links used by XY-routed network-layer multicast.

        Models the ESP-style router behaviour: one packet follows
        XY routes to every destination; branches that share a prefix
        share the links (the router replicates at divergence points).
        The link set is therefore the union of the per-destination XY
        paths.
        """
        links: set[Link] = set()
        for d in dsts:
            links.update(self.xy_path(src, d))
        return links

    def snake_order(self) -> list[int]:
        """Boustrophedon (snake) node order — a Hamiltonian path on the
        mesh where every hop is 1 physical link. The natural 'perfect'
        chain order when the destination set is the whole mesh."""
        order: list[int] = []
        for y in range(self.ny):
            xs = range(self.nx) if y % 2 == 0 else range(self.nx - 1, -1, -1)
            order.extend(self.node_id((x, y)) for x in xs)
        return order


@dataclasses.dataclass(frozen=True)
class TieredMeshTopology(MeshTopology):
    """Two-tier weighted mesh: the global ``nx × ny`` mesh tiled into
    ``pods_x × pods_y`` equal pods. Links inside a pod are uniform
    (:data:`UNIFORM_LINK`); links crossing a pod boundary carry
    ``LinkAttrs(interpod_bw, interpod_latency, tier=1)`` — the slow
    chip-to-chip/inter-pod fabric. A neutral tiering (``interpod_bw=1.0,
    interpod_latency=1``) weighs exactly like the uniform mesh (pinned),
    though it still *labels* boundary links tier 1 for crossing counts.
    """

    pods_x: int = 1
    pods_y: int = 1
    interpod_bw: float = 0.25
    interpod_latency: int = 4

    def __post_init__(self) -> None:
        if self.pods_x < 1 or self.pods_y < 1:
            raise ValueError(
                f"pods must be >= 1, got {self.pods_x}x{self.pods_y}"
            )
        if self.nx % self.pods_x or self.ny % self.pods_y:
            raise ValueError(
                f"pods {self.pods_x}x{self.pods_y} must tile the "
                f"{self.nx}x{self.ny} mesh evenly"
            )
        if not 0.0 < self.interpod_bw <= 1.0:
            raise ValueError(
                f"interpod_bw must be in (0, 1], got {self.interpod_bw}"
            )
        if self.interpod_latency < 1:
            raise ValueError(
                f"interpod_latency must be >= 1, got {self.interpod_latency}"
            )

    @classmethod
    def from_pods(
        cls,
        num_pods: int,
        pod_nx: int,
        pod_ny: int,
        *,
        torus: bool = False,
        interpod_bw: float = 0.25,
        interpod_latency: int = 4,
    ) -> "TieredMeshTopology":
        """``num_pods`` pods of ``pod_nx × pod_ny`` each, arranged in a
        near-square pod grid (4 pods of 4x4 -> an 8x8 global mesh)."""
        if num_pods < 1:
            raise ValueError(f"num_pods must be >= 1, got {num_pods}")
        py = max(1, math.isqrt(num_pods))
        while num_pods % py:
            py -= 1
        px = num_pods // py
        return cls(
            nx=px * pod_nx, ny=py * pod_ny, torus=torus,
            pods_x=px, pods_y=py,
            interpod_bw=interpod_bw, interpod_latency=interpod_latency,
        )

    # -- pod helpers --------------------------------------------------
    @property
    def pod_nx(self) -> int:
        return self.nx // self.pods_x

    @property
    def pod_ny(self) -> int:
        return self.ny // self.pods_y

    @property
    def num_pods(self) -> int:
        return self.pods_x * self.pods_y

    def pod_of(self, node: Coord | int) -> int:
        x, y = self.coord(node) if isinstance(node, int) else node
        return (y // self.pod_ny) * self.pods_x + (x // self.pod_nx)

    def pod_members(self, pod: int) -> list[int]:
        """Node ids of one pod, in row-major order."""
        if not 0 <= pod < self.num_pods:
            raise ValueError(f"pod {pod} outside {self.pods_x}x{self.pods_y}")
        px, py = pod % self.pods_x, pod // self.pods_x
        return [
            self.node_id((x, y))
            for y in range(py * self.pod_ny, (py + 1) * self.pod_ny)
            for x in range(px * self.pod_nx, (px + 1) * self.pod_nx)
        ]

    # -- weighted link-graph contract ---------------------------------
    @functools.cached_property
    def _interpod_attrs(self) -> LinkAttrs:
        return LinkAttrs(
            bandwidth=self.interpod_bw,
            latency=self.interpod_latency,
            tier=1,
        )

    def link_attrs(self, link: Link) -> LinkAttrs:
        (ax, ay), (bx, by) = link
        if ax // self.pod_nx != bx // self.pod_nx or (
            ay // self.pod_ny != by // self.pod_ny
        ):
            return self._interpod_attrs
        return UNIFORM_LINK

    def weighted_distance(self, a: Coord | int, b: Coord | int) -> int:
        return sum(self.link_attrs(l).latency for l in self.xy_path(a, b))

    def path_min_bw(self, a: Coord | int, b: Coord | int) -> float:
        return min(
            (self.link_attrs(l).bandwidth for l in self.xy_path(a, b)),
            default=1.0,
        )

    def path_tier_crossings(self, a: Coord | int, b: Coord | int) -> int:
        return sum(
            1 for l in self.xy_path(a, b) if self.link_attrs(l).tier > 0
        )

    def spec(self) -> str:
        return (
            f"{self.nx}x{self.ny}:pods={self.pods_x}x{self.pods_y}"
            f":interpod_bw={self.interpod_bw:g}"
            f":interpod_lat={self.interpod_latency}"
            + (":torus" if self.torus else "")
        )


@dataclasses.dataclass(frozen=True)
class LinkGraph:
    """Fully explicit weighted link graph: ``num_nodes`` nodes and a
    tuple of directed ``(src, dst, LinkAttrs)`` links. Routes are
    latency-weighted Dijkstra shortest paths (deterministic: ties break
    toward smaller node ids) — the general model the mesh classes'
    XY-routed aggregates are property-tested against, and the substrate
    for topologies the 2-D constructors cannot express."""

    num_nodes: int
    links: tuple[tuple[int, int, LinkAttrs], ...]

    def __post_init__(self) -> None:
        if self.num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {self.num_nodes}")
        for a, b, attrs in self.links:
            if not (0 <= a < self.num_nodes and 0 <= b < self.num_nodes):
                raise ValueError(f"link ({a},{b}) out of range")
            if a == b:
                raise ValueError(f"self-link on node {a}")
            if attrs.latency < 1 or not 0.0 < attrs.bandwidth:
                raise ValueError(f"bad link attrs on ({a},{b}): {attrs}")

    @functools.cached_property
    def _adj(self) -> dict[int, tuple[tuple[int, LinkAttrs], ...]]:
        adj: dict[int, list[tuple[int, LinkAttrs]]] = {
            n: [] for n in range(self.num_nodes)
        }
        for a, b, attrs in self.links:
            adj[a].append((b, attrs))
        return {n: tuple(sorted(nbrs)) for n, nbrs in adj.items()}

    def link_attrs(self, a: int, b: int) -> LinkAttrs:
        for m, attrs in self._adj[a]:
            if m == b:
                return attrs
        raise ValueError(f"no link ({a},{b}) in graph")

    def shortest_path(self, a: int, b: int) -> list[tuple[int, int]]:
        """Latency-minimal route a -> b as a list of (src, dst) node-id
        links (empty when ``a == b``); raises when unreachable."""
        if not (0 <= a < self.num_nodes and 0 <= b < self.num_nodes):
            raise ValueError(f"nodes ({a},{b}) out of range")
        if a == b:
            return []
        dist: dict[int, int] = {a: 0}
        prev: dict[int, int] = {}
        heap: list[tuple[int, int]] = [(0, a)]
        while heap:
            d, n = heapq.heappop(heap)
            if n == b:
                break
            if d > dist.get(n, d):
                continue
            for m, attrs in self._adj[n]:
                nd = d + attrs.latency
                if nd < dist.get(m, nd + 1):
                    dist[m] = nd
                    prev[m] = n
                    heapq.heappush(heap, (nd, m))
        if b not in dist:
            raise ValueError(f"node {b} unreachable from {a}")
        path: list[tuple[int, int]] = []
        cur = b
        while cur != a:
            path.append((prev[cur], cur))
            cur = prev[cur]
        return path[::-1]

    def path_cost(self, path: Sequence[tuple[int, int]]) -> int:
        """Summed link latency of an explicit route."""
        return sum(self.link_attrs(a, b).latency for a, b in path)

    def weighted_distance(self, a: int, b: int) -> int:
        return self.path_cost(self.shortest_path(a, b))

    def path_min_bw(self, a: int, b: int) -> float:
        return min(
            (self.link_attrs(s, d).bandwidth
             for s, d in self.shortest_path(a, b)),
            default=1.0,
        )

    def path_tier_crossings(self, a: int, b: int) -> int:
        return sum(
            1 for s, d in self.shortest_path(a, b)
            if self.link_attrs(s, d).tier > 0
        )


def parse_topology_spec(
    spec: str, num_nodes: int | None = None
) -> MeshTopology:
    """Parse the CLI topology grammar (shared by ``dryrun --topology``,
    ``train --topology`` and ``benchmarks/bench_collectives.py``).

    Colon-separated clauses, order-insensitive after the first:

    * ``"8x8"``                       — uniform mesh;
    * ``"8x8:torus"``                 — uniform torus;
    * ``"pods=4x(4x4)"``              — 4 pods of 4x4 each, near-square
      pod grid (:meth:`TieredMeshTopology.from_pods`);
    * ``"16x1:pods=4x1"``             — explicit global mesh + pod grid;
    * ``"pods=4"``                    — *relative* form: tile a known
      1-D ring (``num_nodes`` required) into 4 equal pods;
    * ``":interpod_bw=0.25"`` / ``":interpod_lat=4"`` — tier-1 link
      weights (defaults 0.25 / 4).

    Round-trips ``topo.spec()`` for every topology class here.
    """
    if not spec or not spec.strip():
        raise ValueError("empty topology spec")
    shape: tuple[int, int] | None = None
    pods: tuple[int, int] | None = None
    pod_shape: tuple[int, int] | None = None
    num_pods: int | None = None
    torus = False
    bw = 0.25
    lat = 4
    tiered = False

    def _pair(text: str, what: str) -> tuple[int, int]:
        parts = text.split("x")
        if len(parts) != 2:
            raise ValueError(f"bad {what} {text!r} in topology spec {spec!r}")
        try:
            a, b = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(
                f"bad {what} {text!r} in topology spec {spec!r}"
            ) from None
        if a < 1 or b < 1:
            raise ValueError(f"{what} must be positive, got {text!r}")
        return a, b

    for clause in spec.strip().split(":"):
        clause = clause.strip()
        if not clause:
            raise ValueError(f"empty clause in topology spec {spec!r}")
        if clause == "torus":
            torus = True
        elif clause.startswith("pods="):
            if pods is not None or num_pods is not None:
                raise ValueError(
                    f"duplicate pods clause in topology spec {spec!r}"
                )
            tiered = True
            val = clause[len("pods="):]
            if "(" in val:  # pods=Px(AxB)
                if not val.endswith(")"):
                    raise ValueError(f"bad pods clause {clause!r}")
                count, inner = val[:-1].split("x(", 1)
                try:
                    num_pods = int(count)
                except ValueError:
                    raise ValueError(f"bad pods clause {clause!r}") from None
                pod_shape = _pair(inner, "pod shape")
            elif "x" in val:  # pods=PXxPY (with an explicit global shape)
                pods = _pair(val, "pod grid")
            else:  # pods=P (relative to a known axis size)
                try:
                    num_pods = int(val)
                except ValueError:
                    raise ValueError(f"bad pods clause {clause!r}") from None
        elif clause.startswith("interpod_bw="):
            tiered = True
            bw = float(clause[len("interpod_bw="):])
        elif clause.startswith("interpod_lat="):
            tiered = True
            lat = int(clause[len("interpod_lat="):])
        elif "x" in clause and shape is None:
            shape = _pair(clause, "mesh shape")
        else:
            raise ValueError(f"unknown clause {clause!r} in topology spec {spec!r}")

    if not tiered:
        if shape is None:
            raise ValueError(f"topology spec {spec!r} has no mesh shape")
        return MeshTopology(shape[0], shape[1], torus=torus)
    if pod_shape is not None:  # pods=Px(AxB)
        if num_pods is None or shape is not None or pods is not None:
            raise ValueError(f"ambiguous pod clauses in {spec!r}")
        return TieredMeshTopology.from_pods(
            num_pods, pod_shape[0], pod_shape[1], torus=torus,
            interpod_bw=bw, interpod_latency=lat,
        )
    if pods is not None:  # NxM:pods=PXxPY
        if shape is None:
            raise ValueError(
                f"pod grid without a global mesh shape in {spec!r}"
            )
        return TieredMeshTopology(
            shape[0], shape[1], torus=torus,
            pods_x=pods[0], pods_y=pods[1],
            interpod_bw=bw, interpod_latency=lat,
        )
    if num_pods is not None:  # pods=P, relative to the axis size
        if shape is not None:
            raise ValueError(
                f"use pods=PXxPY with an explicit mesh shape ({spec!r})"
            )
        if num_nodes is None:
            raise ValueError(
                f"relative spec {spec!r} needs a known axis size"
            )
        if num_nodes % num_pods:
            raise ValueError(
                f"pods={num_pods} must divide the axis size {num_nodes}"
            )
        return TieredMeshTopology(
            num_nodes, 1, torus=torus, pods_x=num_pods, pods_y=1,
            interpod_bw=bw, interpod_latency=lat,
        )
    # only interpod_* clauses given: weights without a pod structure
    if shape is None:
        raise ValueError(f"topology spec {spec!r} has no mesh shape")
    raise ValueError(
        f"interpod weights without a pods= clause in {spec!r}"
    )
