from .attention import (FLASH_MIN_ELEMS, dot_product_attention, merge_heads,
                        reference_attention, split_heads)
