from repro_torch.serve.engine import GenerateConfig, GenerateResult, generate

__all__ = ["GenerateConfig", "GenerateResult", "generate"]
