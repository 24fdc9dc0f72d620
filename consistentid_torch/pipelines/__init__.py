from .consistentid_sd15 import (ConsistentIDPipeline, SD15Bundle,
                                select_key_regions)
