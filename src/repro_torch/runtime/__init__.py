from repro_torch.runtime.serve_loop import ServeConfig, serve

__all__ = ["ServeConfig", "serve"]
