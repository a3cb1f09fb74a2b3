"""VGG16 on CIFAR: the paper's own test network (§V)."""
from repro_torch.core.cim_layer import CIMConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.models.cnn import VGG16_CFG, VGG_SMALL_CFG

FULL_PLAN = VGG16_CFG
SMALL_PLAN = VGG_SMALL_CFG


def cim_config(w_bits=8, a_bits=4, alpha=16, n=16, lambda_g=1e-4,
               mode="qat"):
    """Paper settings: alpha = N = 16 (§V.B.1)."""
    return CIMConfig(
        quant=QuantConfig(w_bits=w_bits, a_bits=a_bits, group_size=alpha),
        sparsity=SparsityConfig(alpha=alpha, n=n, lambda_g=lambda_g),
        mode=mode,
    )
