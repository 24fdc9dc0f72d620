from .clip_tokenizer import CLIPBPETokenizer
from .markers import (FACIAL_KEYWORDS, FACIAL_MARKER, IMAGE_MARKER,
                      process_text_with_markers, remove_duplicate_keywords)
from .masks import (MASK_VALUE_TABLE, fetch_mask_raw_image,
                    masks_for_unique_values)
from .simple_tokenizer import SimpleTokenizer
from .tokenize import prepare_trigger_token_idx, tokenize_and_mask_trigger_ends
