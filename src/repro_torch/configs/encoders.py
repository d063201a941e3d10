"""The paper's own dense-retrieval encoder configs (copies of
``repro/configs/encoders.py``: the same fields and values).

dragon    — BERT-base-style dual encoder, 768-d, inner product
snowflake — XLM-R-large-style shared encoder, 1024-d, cosine
"""
from repro_torch.models.encoder import EncoderConfig


def dragon_config() -> EncoderConfig:
    return EncoderConfig(name="dragon", n_layers=12, d_model=768,
                         n_heads=12, d_ff=3072, vocab=32768, max_len=256,
                         normalize=True, shared_towers=False)


def snowflake_config() -> EncoderConfig:
    return EncoderConfig(name="snowflake", n_layers=24, d_model=1024,
                         n_heads=16, d_ff=4096, vocab=32768, max_len=256,
                         normalize=True, shared_towers=True)


def small_encoder_config() -> EncoderConfig:
    """~100M-class encoder (the reference's examples/ size)."""
    return EncoderConfig(name="mini-dragon", n_layers=4, d_model=256,
                         n_heads=8, d_ff=1024, vocab=8192, max_len=64,
                         out_dim=64, normalize=True, shared_towers=False)


def tiny_encoder_config() -> EncoderConfig:
    return EncoderConfig(name="tiny-encoder", n_layers=2, d_model=64,
                         n_heads=4, d_ff=128, vocab=1024, max_len=32,
                         out_dim=32, normalize=True, shared_towers=False)
