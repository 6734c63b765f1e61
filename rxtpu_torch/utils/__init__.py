from rxtpu_torch.utils.profiling import profile_step_loop, trace

__all__ = ["profile_step_loop", "trace"]
