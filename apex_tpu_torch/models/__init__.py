from apex_tpu_torch.models.gpt import GPTConfig, GPTModel

__all__ = ["GPTConfig", "GPTModel"]
