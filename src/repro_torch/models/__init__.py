"""The LM stack on the port: parameter records, attention (with the flash
kernel on causal prefill), MLP, MoE, Mamba-2 and the generic ``LM``
covering the ten architectures of ``repro_torch.configs``."""
