from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, sgd, momentum, adam, get_client_optimizer,
)
from repro_torch.optim.server import (  # noqa: F401
    ServerOptimizer, fedavg_server, fedadam_server, fedyogi_server,
    get_server_optimizer,
)
