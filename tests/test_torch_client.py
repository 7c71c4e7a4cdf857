"""The port's client package (kektordb_tpu_torch/client: the HTTP SDK, its
cognitive helpers, the LangChain store and the curses `tui`), copies of
the JAX package's, against the port's server and CLI.

The reference's own cases run here: tests/test_client_sdk.py (9 cases,
the sharded-index one included: shards=8 on the CPU by the device-repeat
setting) and tests/test_tui.py (2 cases, `python -m kektordb_tpu_torch tui`
in a pseudo-terminal). Their source is read, every `kektordb_tpu` module
becomes its `kektordb_tpu_torch` copy (test_torch_port_reference), and
their server fixture becomes the port's server on an Engine on DEVICE."""

import os
import re
from pathlib import Path

from test_torch_port_reference import DEVICE, reference_cases
from test_torch_server import Server

from kektordb_tpu_torch import device as devlib
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.services.embeddings import HashingEmbedder
from kektordb_tpu_torch.services.gardener import Gardener, GardenerConfig

_HERE = Path(__file__).resolve().parent
_ROOT = str(_HERE.parent)


class ServerFixture:
    """The reference fixture's surface (`engine`, `base`, `stop`) over the
    port's server, with 8 devices visible (DEVICE, repeated) while it
    runs."""

    def __init__(self):
        self._repeat = os.environ.get(devlib.DEVICE_REPEAT_ENV)
        os.environ[devlib.DEVICE_REPEAT_ENV] = "8"
        self.engine = Engine(EngineConfig(device=DEVICE,
                                          start_background=False)).open()
        gardener = Gardener(self.engine, config=GardenerConfig(),
                            embedder=HashingEmbedder())
        self._srv = Server(self.engine, gardener=gardener)
        self.base = self._srv.base

    def stop(self):
        self._srv.stop()
        self.engine.close()
        if self._repeat is None:
            os.environ.pop(devlib.DEVICE_REPEAT_ENV, None)
        else:
            os.environ[devlib.DEVICE_REPEAT_ENV] = self._repeat


def _port_source(src: str) -> str:
    """`reference_cases` with this file's ServerFixture in place of
    test_http's, and the checkout as the CLI's working directory."""
    src = re.sub(r"^from (tests\.)?test_http import ServerFixture$", "",
                 src, flags=re.M)
    return re.sub(r'cwd="[^"]*"', "cwd=_ROOT", src)


exec(compile(_port_source(reference_cases("test_client_sdk.py")),
             str(_HERE / "test_client_sdk.py"), "exec"))
exec(compile(_port_source(reference_cases("test_tui.py")),
             str(_HERE / "test_tui.py"), "exec"))


def test_reference_cases_were_ported():
    for ref in ("test_client_sdk.py", "test_tui.py"):
        src = _port_source(reference_cases(ref))
        assert "test_http" not in src
        assert not re.search(r"\bkektordb_tpu\b", src)
    assert '"-m", "kektordb_tpu_torch", "tui"' in \
        _port_source(reference_cases("test_tui.py"))
