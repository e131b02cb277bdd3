"""Training subsystem — flow-matching fine-tuning and LoRA training.

The reference is inference-only (SURVEY.md: "It is an inference-only
system (no training)"); this package is a beyond-parity capability built
on the same functional pytree models:

* flow_match.py — the rectified-flow training objective using the exact
  forward/target conventions the inference scheduler already pins
  (ops/schedule.py::add_noise / velocity_target);
* lora.py — trainable low-rank adapters inserted INTO the stacked-block
  param tree ({"lora_a","lora_b","lora_s"} beside the base weight), read
  transparently by kernels/quantization.py::linear_any, so one lax.scan
  body serves base, quantized, and LoRA-bearing blocks alike;
* step.py — jittable train step (full fine-tune or LoRA-only) with optax,
  remat over the block scan, and dp+tp mesh sharding via the same
  partition specs the inference path uses;
* export.py — serialize trained adapters to the ComfyUI/Diffusers LoRA
  safetensors schema the inference fusion path consumes (round-trip).
"""

from ltx_jax.train.checkpoint import (
    load_train_checkpoint, save_train_checkpoint,
)
from ltx_jax.train.export import lora_state_dict, save_lora
from ltx_jax.train.flow_match import (
    av_flow_match_loss, flow_match_loss, sample_sigmas,
)
from ltx_jax.train.lora import (
    add_lora, lora_param_mask, merge_lora, strip_lora,
)
from ltx_jax.train.step import (
    TrainConfig, ema_init, make_av_train_step, make_ema_update,
    make_optimizer, make_train_step,
)

__all__ = [
    "flow_match_loss", "av_flow_match_loss", "sample_sigmas",
    "make_av_train_step",
    "add_lora", "lora_param_mask", "merge_lora", "strip_lora",
    "TrainConfig", "make_optimizer", "make_train_step",
    "lora_state_dict", "save_lora",
    "save_train_checkpoint", "load_train_checkpoint",
    "ema_init", "make_ema_update",
]
