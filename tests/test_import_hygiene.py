"""The device path imports no package beyond JAX and numpy's circle.

tokenizers, safetensors, PIL, imageio, cv2 and huggingface_hub serve the IO
edges (weights on disk, media files, downloads) and are imported lazily
there. A tiny pipeline run — enhance, encode, denoise, decode — in a fresh
interpreter must leave all of them unimported.
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys, types
import jax
jax.config.update("jax_platforms", "cpu")
from ltx_jax.core.config import GenerationConfig
from ltx_jax.pipeline.generate import LTXPipeline

class Tok:
    def encode(self, text):
        return types.SimpleNamespace(ids=[b % 60 + 2 for b in text.encode()])
    def decode(self, ids):
        return " ".join(map(str, ids))

pipe = LTXPipeline.random_tiny(seed=0)
pipe.tokenizer = Tok()
cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=8,
                       seed=1, enhance_prompt=True)
result = pipe.generate_video("a cat", cfg)
assert result.frames.shape == (9, 64, 64, 3)
bad = [m for m in ("tokenizers", "safetensors", "PIL", "imageio", "cv2",
                   "huggingface_hub") if m in sys.modules]
print("LOADED", bad)
"""


def test_tiny_pipeline_run_imports_no_io_packages():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
