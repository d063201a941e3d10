"""The LM serving and training shapes (a copy of
``repro/configs/common.py:91-114``: ``LM_SHAPES``, ``LM_SHAPE_PARAMS``
and ``LM_SMOKE_SHAPE_PARAMS``, the same keys and values)."""

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

LM_SHAPE_PARAMS = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="serve", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="serve", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="serve", seq_len=524288, global_batch=1),
}

# reduced shapes for harness debugging (--smoke); batch >= 32 so both
# production meshes shard the batch dim
LM_SMOKE_SHAPE_PARAMS = {
    "train_4k": dict(kind="train", seq_len=128, global_batch=64),
    "prefill_32k": dict(kind="serve", seq_len=128, global_batch=32),
    "decode_32k": dict(kind="serve", seq_len=256, global_batch=64),
    "long_500k": dict(kind="serve", seq_len=512, global_batch=32),
}
