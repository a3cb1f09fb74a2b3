"""ResNet18 on CIFAR: the paper's own test network (§V), with VGG16's CIM
settings (alpha = N = 16, w8a4, lambda_g 1e-4, qat)."""
from repro_torch.configs.vgg16_cifar import cim_config  # noqa: F401
from repro_torch.models.cnn import RESNET18_STAGES, RESNET_SMALL_STAGES

FULL_STAGES = RESNET18_STAGES
SMALL_STAGES = RESNET_SMALL_STAGES
