from segtpu_torch.engine.inference import (  # noqa: F401
    STRIDE, Segmenter, ShardedSegmenter, pad_to_stride)
