"""repro_torch.runtime"""
