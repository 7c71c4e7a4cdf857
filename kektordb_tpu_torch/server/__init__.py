from .http import make_app, run_server  # noqa: F401
