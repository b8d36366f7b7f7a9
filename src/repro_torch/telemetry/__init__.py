"""repro_torch.telemetry"""
