from repro_torch.models.mlp_model import PaperMLP  # noqa: F401
from repro_torch.models.model import Model, build_model  # noqa: F401
