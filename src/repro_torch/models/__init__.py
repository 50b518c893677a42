from repro_torch.models.mlp_model import PaperMLP  # noqa: F401
