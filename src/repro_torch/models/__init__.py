from repro_torch.models.cnn import (  # noqa: F401
    CIFAR_CNN, CNN, CNNConfig, MEDMNIST_CNN,
)
