from repro_torch.federated.partition import dirichlet_partition, power_law_fractions
from repro_torch.federated.client import ClientConfig, client_update, local_loss
from repro_torch.federated.server import FLConfig, run_federated, FLResult

__all__ = [
    "dirichlet_partition", "power_law_fractions",
    "ClientConfig", "client_update", "local_loss",
    "FLConfig", "run_federated", "FLResult",
]
