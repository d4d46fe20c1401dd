from segtpu_torch.data.transforms import (  # noqa: F401
    Pad, RandomCrop, RandomMirror, ResizeShorterScale, Normalise, Compose)
from segtpu_torch.data.datasets import (  # noqa: F401
    SegmentationDataset, SyntheticDataset, create_loaders, BatchLoader)
