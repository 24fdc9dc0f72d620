from .dataset import FGIDDataset, synthetic_batch
from .losses import (balanced_l1_loss, collect_attn_probs, localization_loss,
                     localization_loss_for_layer, masked_mse, resize_bilinear)
from .optim import AdamW, make_optimizer
from .precompute import (EncodedFGIDDataset, pack_float,
                         precompute_conditioning, synthetic_encoded_batch,
                         unpack_float)
from .sdxl_loss import sdxl_consistentid_loss
from .train_step import (Draws, TrainState, consistentid_loss,
                         consistentid_loss_encoded, create_train_state,
                         is_trainable_path, make_draws, make_multi_train_step,
                         make_train_step, merge_params, split_params,
                         warm_start_ip_projections)
