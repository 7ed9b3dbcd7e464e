from .chunked import attention_chunked
from .ops import attention_ref, flash_attention, flash_attention_plain
