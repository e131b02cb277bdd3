"""ModelDownloader layout + caching, network-free (hf_hub stubbed).

The reference's per-component cache layout (ModelDownloader.swift:147-530):
vlm-gemma/, ltx-{variant}/<unified>.safetensors, ltx-vae/, ltx-upscaler/,
ltx-lora/, ltx-audio-vae/, ltx-vocoder/ — with skip-if-exists caching.
"""

import sys
import types
from pathlib import Path

import pytest

from ltx_jax.core.config import LTXModel
from ltx_jax.core.errors import DownloadFailedError
from ltx_jax.weights import download as dl


@pytest.fixture
def fake_hub(monkeypatch):
    """Stub huggingface_hub: record requests, create placeholder files."""
    calls = {"files": [], "snapshots": []}

    def hf_hub_download(repo_id, filename, token=None, local_dir=None):
        calls["files"].append((repo_id, filename))
        # the real client PRESERVES the hub filename's subpath under
        # local_dir (verified against the live client in
        # test_download_e2e.py); _download_file flattens afterwards
        p = Path(local_dir) / filename
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"fake")
        return str(p)

    def snapshot_download(repo_id, token=None, local_dir=None):
        calls["snapshots"].append(repo_id)
        base = Path(local_dir)
        base.mkdir(parents=True, exist_ok=True)
        (base / "model.safetensors").write_bytes(b"fake")
        (base / "config.json").write_text("{}")
        return str(base)

    mod = types.ModuleType("huggingface_hub")
    mod.hf_hub_download = hf_hub_download
    mod.snapshot_download = snapshot_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", mod)
    return calls


def test_layout_and_repo_files(tmp_path, fake_hub):
    paths = dl.download_all_components(
        LTXModel.DISTILLED, models_dir=str(tmp_path), include_audio=True)

    base = tmp_path
    assert paths["gemma"] == base / "vlm-gemma"
    assert paths["unified"] == (base / "ltx-distilled"
                                / LTXModel.DISTILLED.unified_weights_filename)
    # standalone connector + VAE downloaded in addition to the unified file
    # (reference: ModelDownloader.swift:435-456)
    assert paths["connector"].parent == base / "ltx-connector"
    assert paths["vae"].parent == base / "ltx-vae"
    assert paths["vae_config"].parent == base / "ltx-vae"
    assert paths["upscaler"].parent == base / "ltx-upscaler"
    assert paths["distilled_lora"].parent == base / "ltx-lora"
    assert paths["audio_vae"].parent == base / "ltx-audio-vae"
    assert paths["vocoder"].parent == base / "ltx-vocoder"
    for p in paths.values():
        assert p.exists(), p

    assert fake_hub["snapshots"] == [dl.GEMMA_REPO]
    repos = {r for r, _ in fake_hub["files"]}
    assert repos == {dl.LTX_REPO}
    files = {f for _, f in fake_hub["files"]}
    assert LTXModel.DISTILLED.unified_weights_filename in files
    assert dl.VAE_CONFIG in files and dl.DISTILLED_LORA_FILE in files
    assert dl.AUDIO_VAE_FILE in files and dl.VOCODER_FILE in files
    assert dl.CONNECTOR_FILE in files and dl.VAE_FILE in files
    assert dl.UPSCALER_FILE in files


_REF_DOWNLOADER = Path("/root/reference/Sources/LTXVideo/Utils/"
                       "ModelDownloader.swift")


@pytest.mark.skipif(not _REF_DOWNLOADER.exists(),
                    reason="reference checkout not available")
def test_hub_filenames_match_reference():
    """Pin every hub filename constant against the literal strings in the
    reference's download table (a typo'd path would otherwise only surface
    at first real download)."""
    src = _REF_DOWNLOADER.read_text()
    for const in (dl.CONNECTOR_FILE, dl.VAE_FILE, dl.VAE_CONFIG,
                  dl.UPSCALER_FILE, dl.DISTILLED_LORA_FILE,
                  dl.AUDIO_VAE_FILE, dl.VOCODER_FILE, dl.GEMMA_REPO,
                  dl.LTX_REPO):
        assert f'"{const}"' in src, const
    cfg_src = Path("/root/reference/Sources/LTXVideo/Configuration/"
                   "LTXConfig.swift").read_text()
    for m in (LTXModel.DEV, LTXModel.DISTILLED):
        assert f'"{m.unified_weights_filename}"' in cfg_src


def test_skip_if_exists_caching(tmp_path, fake_hub):
    dl.download_all_components(LTXModel.DISTILLED, models_dir=str(tmp_path))
    n = len(fake_hub["files"])
    # second call: everything cached -> no new hub requests
    dl.download_all_components(LTXModel.DISTILLED, models_dir=str(tmp_path))
    assert len(fake_hub["files"]) == n
    assert fake_hub["snapshots"] == [dl.GEMMA_REPO]
    # force re-downloads
    dl.download_all_components(LTXModel.DISTILLED, models_dir=str(tmp_path),
                               force=True)
    assert len(fake_hub["files"]) > n


def test_download_error_is_typed(tmp_path, monkeypatch):
    mod = types.ModuleType("huggingface_hub")

    def boom(**kw):
        raise OSError("no network")

    mod.hf_hub_download = boom
    mod.snapshot_download = boom
    monkeypatch.setitem(sys.modules, "huggingface_hub", mod)
    with pytest.raises(DownloadFailedError):
        dl.download_gemma(models_dir=str(tmp_path))


def test_dev_variant_unified_filename(tmp_path, fake_hub):
    paths = dl.download_all_components(LTXModel.DEV, models_dir=str(tmp_path),
                                       include_upscaler=False)
    assert paths["unified"].name == LTXModel.DEV.unified_weights_filename
    assert "upscaler" not in paths


# --- registry (reference: LTXModelRegistry.swift) ---------------------------

def test_registry_status_tracks_downloads(tmp_path, fake_hub):
    from ltx_jax.weights import registry as reg

    assert not reg.is_downloaded("unified", str(tmp_path))
    assert reg.missing_files("vae", str(tmp_path)) == [
        "diffusion_pytorch_model.safetensors", "config.json"]

    dl.download_all_components(LTXModel.DISTILLED, models_dir=str(tmp_path),
                               include_audio=True)
    for comp in ("unified", "connector", "vae", "upscaler",
                 "distilled_lora", "audio_vae", "vocoder"):
        assert reg.is_downloaded(comp, str(tmp_path)), comp
    # the fake snapshot lacks tokenizer.json -> gemma stays incomplete
    assert reg.missing_files("gemma", str(tmp_path)) == ["tokenizer.json"]
    (tmp_path / "vlm-gemma" / "tokenizer.json").write_text("{}")
    assert reg.is_downloaded("gemma", str(tmp_path))
    # dev unified is a separate artifact
    assert not reg.is_downloaded("unified", str(tmp_path), LTXModel.DEV)


def test_registry_inventory_matches_download_layout(tmp_path, fake_hub):
    """Every inventory (subdir, file) pair is exactly where
    download_all_components puts it — the two tables cannot drift."""
    from ltx_jax.weights import registry as reg

    dl.download_all_components(LTXModel.DEV, models_dir=str(tmp_path),
                               include_audio=True)
    inv = reg.component_inventory(LTXModel.DEV)
    for comp, (subdir, files) in inv.items():
        if comp == "gemma":
            continue  # snapshot contents are repo-defined
        for f in files:
            assert (tmp_path / subdir / f).exists(), (comp, subdir, f)


def test_recommended_model_by_mesh_hbm():
    from ltx_jax.weights import registry as reg

    # a 16 GB device runs distilled int4 alone, and dev bf16 over a mesh
    model, quant = reg.recommended_model(n_devices=1, memory_per_device_gb=16)
    assert model is LTXModel.DISTILLED and quant == "int4"
    model, quant = reg.recommended_model(n_devices=8, memory_per_device_gb=16)
    assert model is LTXModel.DEV and quant is None
    # one 80 GB card at JAX's default 0.75 share holds 19B bf16
    model, quant = reg.recommended_model(n_devices=1, memory_per_device_gb=60)
    assert model is LTXModel.DEV and quant is None
