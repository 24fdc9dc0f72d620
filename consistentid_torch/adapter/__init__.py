from .modules import (MLP, AttentionMLP, FacialEncoder, FuseModule,
                      ProjPlusModel)
from .perceiver import FacePerceiverResampler, FeedForward, PerceiverAttention
