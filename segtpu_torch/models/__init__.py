from segtpu_torch.models.arch_literals import ARCHS, TEMPLATE_ARCHS  # noqa: F401
from segtpu_torch.models.encoders import (  # noqa: F401
    MBV2_TAP_CHANNELS, MobileNetV2)
from segtpu_torch.models.micro_decoders import (  # noqa: F401
    GenotypeError, MicroDecoder, validate_genotype)
from segtpu_torch.models.segmenter import (  # noqa: F401
    Segmenter, create_segmenter)
from segtpu_torch.models.template_decoders import (  # noqa: F401
    TemplateDecoder, validate_template_genotype)
