"""What the ``examples/torch_*.py`` twins print that no weight decides,
at the JAX examples' defaults: hops, orders, cycle ledgers, multicast
records, pages, decode steps, wire bytes and cycle pairs.

``tests/test_torch_examples.py`` holds the twins on the CPU to these
values and to the JAX examples; ``chip_smoke.py``'s examples phase holds
the card's run to them. Plain Python: it imports neither torch nor JAX.
"""

QUICKSTART_SCHEDULING = {
    "dests": [1, 3, 5, 11, 15, 18, 28, 34, 41, 45, 50, 58],
    "unicast_hops": 71,
    "multicast_hops": 29,
    "orders": {"greedy": [1, 3, 11, 18, 34, 41, 50, 58, 45, 28, 5, 15],
               "tsp": [1, 18, 34, 58, 50, 41, 45, 28, 11, 3, 5, 15]},
    "chain_hops": {"greedy": 28, "tsp": 28},
}
QUICKSTART_CHAINTASK = {
    "delivered": [3, 7, 12, 18],
    "intact": True,
    "cycles": {"cfg": 58, "grant": 75, "data": 1207, "finish": 75, "total": 1415},
    "speedup_vs_unicast": 4160 / 1415,
}

# torch_serve_batch.py at its defaults (12 requests, 16 new tokens,
# yi-6b-smoke, 8 replicas): the KV and weight multicast records, the
# pages a replica holds and Server.run's schedule
SERVE_KV = {"prefix_len": 8, "bytes": 2048, "delivered_bytes": 14336, "wire_bytes": 10240,
            "replicas": 8, "cycles": 337, "modeled_cycles": 337, "unicast_cycles": 336,
            "speedup_vs_unicast": 336 / 337}
SERVE_PAGES = 1
SERVE_RUN = {"requests": 12, "served": 12, "generated_tokens": 192, "decode_steps": 45,
             "prefix_hit_rate": 0.5, "prefix_entries": 1, "prefix_bytes": 20480,
             "prefix_evictions": 0, "prefix_invalidations": 0,
             "latency_ticks_p50": 30.0, "latency_ticks_p99": 45.0,
             "weight_multicast": {"bytes": 427264, "delivered_bytes": 2990848, "chunks": 1,
                                  "replicas": 8, "cycles": 6981,
                                  "speedup_vs_unicast": 46844 / 6981,
                                  "prefix_invalidated": 0},
             "kv_multicast": SERVE_KV}

CHAINWRITE_ORDER = (1, 5, 6, 3)
CHAINWRITE_MEANS = {d: 1.0 if d in CHAINWRITE_ORDER else 0.0 for d in range(8)}
CHAINWRITE_SUM_MEAN = 28.0  # every device's mean after the all-reduce
CHAINWRITE_WIRE_BYTES = 448  # 2 * 7/8 of the 16 x 4 f32 payload

# (name, XDMA cycles, Chainwrite cycles, relayout route on the card)
DEEPSEEK = [
    ("P1:QKT_Single_Head", 49266, 6840, "staged"),
    ("P2:SV_Single_Head", 32882, 4792, "staged"),
    ("P3:KV_Matrix_MLA_Recovery", 131186, 17080, "copy"),
    ("D1:QKT_Single_Head", 12301, 12407, "staged"),
    ("D2:SV_Single_Head", 8205, 8311, "staged"),
    ("D3:KV_Matrix_MLA_Recovery", 262258, 33464, "copy"),
]

# kernel launches of the twins' path on the card, by route: the server's
# paging (the head's and each of 7 replicas' pages, ``copy``) and the six
# deepseek relayouts; yi-6b-smoke attends by the reference attention, so
# no flash kernel runs
RELAYOUT_LAUNCHES = {"copy": 8 + sum(r == "copy" for *_, r in DEEPSEEK),
                     "staged": sum(r == "staged" for *_, r in DEEPSEEK), "direct": 0}
