from repro_torch.exec.backend import (BACKEND_NAMES, ClientExecution,  # noqa: F401
                                ClosedFormBackend, ExecutionBackend,
                                SchedulerBackend, make_backend)
