from repro_torch.models.cnn import (  # noqa: F401
    CIFAR_CNN, CNN, CNNConfig, MEDMNIST_CNN,
)
from repro_torch.models.transformer import (  # noqa: F401
    LM, active_param_count, build_model, param_count, token_shape,
)
