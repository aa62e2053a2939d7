from .main import Pod, launch, main, parse_args  # noqa: F401
