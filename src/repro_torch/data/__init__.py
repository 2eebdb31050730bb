from repro_torch.data.synthetic import (  # noqa: F401
    Dataset, cifar10_like, medmnist_like, shakespeare_like, lm_token_batch,
)
from repro_torch.data.partition import (  # noqa: F401
    partition_by_class, partition_by_group, partition_dirichlet,
    partition_quantity_skew,
)
from repro_torch.data.federated import FederatedDataset, VirtualFederatedDataset  # noqa: F401
