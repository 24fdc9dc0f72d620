from .consistentid_sd15 import (ConsistentIDPipeline, SD15Bundle,
                                select_key_regions)
from .consistentid_sdxl import (ConsistentIDXLPipeline, SDXLBundle,
                                sdxl_adapter_config)
