from .encoder import EmbeddingModel, Encoder, EncoderConfig, tokenize_batch
