"""repro_torch.models"""
