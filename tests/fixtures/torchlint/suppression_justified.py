"""torchlint fixture: a real finding silenced by a JUSTIFIED suppression —
analyzes clean (exit 0), with the finding marked suppressed."""
import torch


def sample(shape):
    return torch.randn(shape)  # torchlint: disable=implicit-rng -- fixture: the global draw is the point of this test file
