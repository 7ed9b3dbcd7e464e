from .ops import (
    blocked_to_dense,
    dense_to_blocked,
    parse_layout,
    relayout,
    relayout_ref,
    relayout_str,
)
