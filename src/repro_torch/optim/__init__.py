from repro_torch.optim.adamw import AdamW, OptState, global_norm

__all__ = ["AdamW", "OptState", "global_norm"]
