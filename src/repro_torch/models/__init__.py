"""The port's model tier: layers, MoE, transformer assembly and the API."""
