from repro_torch.serve.engine import (  # noqa: F401
    ServeConfig,
    ServerState,
    init_server,
    make_serve_step,
    submit,
)
