from repro_torch.sched.adapter import JobSpec, JobHandle, JobState, SchedulerAdapter  # noqa: F401
from repro_torch.sched.slurm import SlurmAdapter  # noqa: F401
from repro_torch.sched.k8s import K8sAdapter, pod_manifest  # noqa: F401
from repro_torch.sched.hybrid import HybridAdapter  # noqa: F401
