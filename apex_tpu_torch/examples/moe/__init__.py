"""The Switch-GPT example (``python -m apex_tpu_torch.examples.moe.train_switch_gpt``)."""
