"""torchlint fixture: a suppression WITHOUT a justification — the rng
finding is silenced, but the bare disable is itself reported."""
import torch


def sample(shape):
    return torch.randn(shape)  # torchlint: disable=implicit-rng
