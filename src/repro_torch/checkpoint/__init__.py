from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointManager, load_pytree, save_pytree,
)
from repro_torch.checkpoint.async_state import (  # noqa: F401
    AsyncCheckpointManager, async_state_dict, hier_state_dict,
    load_async_state, load_hier_state, load_sync_state, sync_state_dict,
)
