from repro_torch.core.round import FLConfig, build_fl_round_step, build_local_train  # noqa: F401
from repro_torch.core.async_round import (AdaptiveStalenessController, AsyncConfig,  # noqa: F401
                                          build_buffer_commit_step,
                                          build_chunked_commit_steps,
                                          build_client_update_step,
                                          staleness_weights)
from repro_torch.core.pipeline import UpdatePipeline, build_update_pipeline  # noqa: F401
from repro_torch.core.compression import CompressionConfig, compress_tree, payload_bytes  # noqa: F401
from repro_torch.core.convergence import ConvergenceMonitor  # noqa: F401
from repro_torch.core.secure_agg import masked_payload_bytes  # noqa: F401
