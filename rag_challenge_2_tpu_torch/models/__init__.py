from .encoder import EmbeddingModel, Encoder, EncoderConfig, tokenize_batch
from .pretrain import (
    PretrainConfig, contrastive_pairs, ict_pairs, load_params,
    pretrain_encoder, save_params,
)
from .train import TrainConfig, contrastive_loss, init_training, make_train_step
