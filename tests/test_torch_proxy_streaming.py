"""The port's AI gateway (services/proxy.py): streaming passthrough and
proxy.yaml, the JAX package's tests/test_proxy_streaming.py.

* The reference's five cases run against the port: a fake upstream that
  streams SSE chunks with gaps, the port's gateway over an Engine on the
  CPU (the cases' source read, every `kektordb_tpu` module made the
  port's).
* One proxy.yaml, flat and nested keys and environment overrides, read by
  both packages' `ProxyConfig.from_yaml`: the same configuration.
"""

from dataclasses import asdict

import pytest
from test_torch_port_reference import reference_cases

from kektordb_tpu.services.proxy import ProxyConfig as JProxyConfig

exec(compile(reference_cases("test_proxy_streaming.py"),
             "test_proxy_streaming.py", "exec"))

YAML = """
upstream_url: http://up:9/v1
upstream_key: k-1
firewall:
  enabled: true
  threshold: 0.7
cache:
  enabled: false
  ttl: 120
  threshold: 0.9
rag:
  enabled: true
  index: docs
deny_list: [secret, password]
unknown_key: 3
"""


@pytest.mark.parametrize("env", [{}, {"KEKTOR_PROXY_RAG_K": "9",
                                      "KEKTOR_PROXY_CACHE_ENABLED": "yes",
                                      "KEKTOR_PROXY_FIREWALL_THRESHOLD":
                                      "0.5"}], ids=["file", "env"])
def test_proxy_yaml_agrees_with_reference(env, tmp_path, monkeypatch):
    p = tmp_path / "proxy.yaml"
    p.write_text(YAML)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = asdict(ProxyConfig.from_yaml(str(p)))      # noqa: F821
    assert port == asdict(JProxyConfig.from_yaml(str(p)))
    assert port["upstream_key"] == "k-1" and port["deny_list"] == \
        ["secret", "password"]
