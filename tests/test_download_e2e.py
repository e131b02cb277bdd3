"""Download happy path against a REAL localhost hub (no network stubs).

tests/test_download.py stubs out huggingface_hub entirely; that stub once
encoded a wrong assumption (it wrote files FLAT, while the real
hf_hub_download(local_dir=...) preserves the hub filename's subpath and
lands "vae/diffusion_pytorch_model.safetensors" at dest/vae/...). This file
closes that gap at the offline ceiling: a ThreadingHTTPServer emulates the
two hub endpoints huggingface_hub 0.36 actually hits (GET/HEAD
/{repo}/resolve/{rev}/{file} and GET /api/models/{repo}), and the tests run
the PRODUCTION download code (weights/download.py) end-to-end through the
genuine huggingface_hub client — resolving, downloading, flattening into the
reference's per-component layout (ModelDownloader.swift:147-530), caching.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from ltx_jax.core.config import LTXModel
from ltx_jax.core.errors import DownloadFailedError
from ltx_jax.weights import download as dl
from ltx_jax.weights import registry

_COMMIT = "0" * 40


def _safetensors_bytes(key="w"):
    from io import BytesIO

    from safetensors.numpy import save

    return save({key: np.ones((2, 2), dtype=np.float32)})


class _FakeHub:
    """Minimal HF-hub protocol server over an in-memory {repo: {file: bytes}}."""

    def __init__(self, repos):
        self.repos = repos
        self.requests = []  # (method, path)
        hub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, head):
                hub.requests.append((self.command, self.path))
                path = self.path.split("?")[0]
                if "/resolve/" in path:
                    repo, rest = path.lstrip("/").split("/resolve/", 1)
                    fname = rest.split("/", 1)[1]  # strip revision
                    body = hub.repos.get(repo, {}).get(fname)
                    if body is None:
                        self.send_response(404)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Repo-Commit", _COMMIT)
                    self.send_header("ETag", '"%s"' % (hash(body) & 0xFFFF))
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.end_headers()
                    if not head:
                        self.wfile.write(body)
                elif path.startswith("/api/models/"):
                    repo = path[len("/api/models/"):].split("/revision/")[0]
                    files = hub.repos.get(repo)
                    if files is None:
                        self.send_response(404)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    info = {
                        "id": repo,
                        "sha": _COMMIT,
                        "siblings": [{"rfilename": f} for f in sorted(files)],
                    }
                    body = json.dumps(info).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    if not head:
                        self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            def do_GET(self):
                self._reply(head=False)

            def do_HEAD(self):
                self._reply(head=True)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _ltx_repo_files(model: LTXModel, payload: bytes):
    return {
        dl.CONNECTOR_FILE: payload,
        dl.VAE_FILE: payload,
        dl.VAE_CONFIG: json.dumps({"timestep_conditioning": True}).encode(),
        dl.UPSCALER_FILE: payload,
        dl.DISTILLED_LORA_FILE: payload,
        dl.AUDIO_VAE_FILE: payload,
        dl.VOCODER_FILE: payload,
        model.unified_weights_filename: payload,
    }


@pytest.fixture
def fake_hub(monkeypatch):
    payload = _safetensors_bytes()
    repos = {
        dl.LTX_REPO: _ltx_repo_files(LTXModel.DISTILLED, payload),
        dl.GEMMA_REPO: {
            "model.safetensors": payload,
            "config.json": json.dumps({"model_type": "gemma3"}).encode(),
            "tokenizer.json": b"{}",
        },
    }
    hub = _FakeHub(repos)
    endpoint = f"http://127.0.0.1:{hub.port}"
    template = endpoint + "/{repo_id}/resolve/{revision}/{filename}"
    from huggingface_hub import constants, file_download

    monkeypatch.setattr(constants, "ENDPOINT", endpoint)
    monkeypatch.setattr(constants, "HUGGINGFACE_CO_URL_TEMPLATE", template)
    # huggingface_hub lazy-imports file_download, which BINDS the template
    # at import time (`from .constants import HUGGINGFACE_CO_URL_TEMPLATE`) —
    # patching constants alone leaves hf_hub_url on whatever endpoint was
    # live at first import, so patch the module binding too.
    monkeypatch.setattr(file_download, "HUGGINGFACE_CO_URL_TEMPLATE",
                        template)
    # Hermetic: never fall back to ambient offline/cache state.
    monkeypatch.setattr(constants, "HF_HUB_OFFLINE", False, raising=False)
    yield hub
    hub.close()


def test_download_all_components_real_client(tmp_path, fake_hub):
    paths = dl.download_all_components(
        LTXModel.DISTILLED, models_dir=str(tmp_path), include_audio=True)

    # Every component lands FLAT in its per-component dir — the layout the
    # registry checks (registry.py::component_inventory) — even though the
    # hub filenames are nested (vae/..., connectors/..., latent_upsampler/...).
    for name in ("connector", "vae", "vae_config", "upscaler",
                 "distilled_lora", "audio_vae", "vocoder", "unified"):
        p = paths[name]
        assert p.exists(), name
        inv_sub = {
            "connector": "ltx-connector", "vae": "ltx-vae",
            "vae_config": "ltx-vae", "upscaler": "ltx-upscaler",
            "distilled_lora": "ltx-lora", "audio_vae": "ltx-audio-vae",
            "vocoder": "ltx-vocoder", "unified": "ltx-distilled",
        }[name]
        assert p.parent == tmp_path / inv_sub, (name, p)
        # no nested leftovers (the pre-fix behavior left vae/ subdirs behind)
        assert not any(q.is_dir() and q.name != ".cache"
                       for q in p.parent.iterdir()), list(p.parent.iterdir())

    # the payloads are real safetensors readable by the production loader
    tree = dl.load_safetensors(paths["vae"])
    assert tree["w"].shape == (2, 2)

    # registry agrees everything is downloaded
    for comp in ("unified", "connector", "vae", "upscaler", "distilled_lora",
                 "audio_vae", "vocoder", "gemma"):
        assert registry.is_downloaded(comp, models_dir=str(tmp_path)), comp


def test_skip_if_exists_makes_no_requests(tmp_path, fake_hub):
    dl.download_all_components(LTXModel.DISTILLED, models_dir=str(tmp_path))
    n = len(fake_hub.requests)
    assert n > 0
    paths = dl.download_all_components(LTXModel.DISTILLED,
                                       models_dir=str(tmp_path))
    # second run is fully cache-served (ModelDownloader.swift:116-118
    # skip-if-exists) — zero hub traffic, same flat paths
    assert len(fake_hub.requests) == n
    assert paths["vae"].exists()


def test_force_redownloads(tmp_path, fake_hub):
    dl.download_all_components(LTXModel.DISTILLED, models_dir=str(tmp_path))
    n = len(fake_hub.requests)
    dl.download_all_components(LTXModel.DISTILLED, models_dir=str(tmp_path),
                               force=True)
    assert len(fake_hub.requests) > n


def test_missing_file_raises_download_failed(tmp_path, fake_hub):
    del fake_hub.repos[dl.LTX_REPO][dl.VAE_FILE]
    with pytest.raises(DownloadFailedError, match="diffusion_pytorch_model"):
        dl.download_all_components(LTXModel.DISTILLED,
                                   models_dir=str(tmp_path))


def test_gemma_snapshot_real_client(tmp_path, fake_hub):
    out = dl.download_gemma(models_dir=str(tmp_path))
    assert out == tmp_path / "vlm-gemma"
    assert (out / "config.json").exists()
    assert (out / "tokenizer.json").exists()
    assert any(out.glob("*.safetensors"))
    assert registry.is_downloaded("gemma", models_dir=str(tmp_path))
    # snapshot skip-if-exists: second call makes no requests
    n = len(fake_hub.requests)
    assert dl.download_gemma(models_dir=str(tmp_path)) == out
    assert len(fake_hub.requests) == n
