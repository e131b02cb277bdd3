"""Gemma-based prompt enhancement.

Reference behavior: Sources/LTXVideo/Pipeline/LTXPipeline.swift:2766-2981 —
reuse the Gemma-3 text model autoregressively with the official Lightricks
system prompts (upstream source cited in the reference:
github.com/Lightricks/LTX-2 packages/ltx-core .../prompts/), fixed seed 42,
temperature 0.7, top-p 0.95, repetition penalty 1.1, max 512 tokens, stop at
<end_of_turn>/<eos>.

The T2V prompt is text-only; the I2V path feeds the conditioning image
through the SigLIP vision tower (models/siglip.py) into 256 soft tokens
that prefix the Gemma context — wired in pipeline/generate.py (enhance
with image=...), matching the reference's VLM-conditioned enhancement.
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional

import jax

from ltx_jax.models import gemma3

log = logging.getLogger("ltx_jax")

# Official Lightricks T2V system prompt (reference: LTXPipeline.swift:2766).
T2V_SYSTEM_PROMPT = """You are a Creative Assistant. Given a user's raw input prompt describing a scene or concept, expand it into a detailed video generation prompt with specific visuals and integrated audio to guide a text-to-video model.

#### Guidelines
- Strictly follow all aspects of the user's raw input: include every element requested (style, visuals, motions, actions, camera movement, audio).
    - If the input is vague, invent concrete details: lighting, textures, materials, scene settings, etc.
        - For characters: describe gender, clothing, hair, expressions. DO NOT invent unrequested characters.
- Use active language: present-progressive verbs ("is walking," "speaking"). If no action specified, describe natural movements.
- Maintain chronological flow: use temporal connectors ("as," "then," "while").
- Audio layer: Describe complete soundscape (background audio, ambient sounds, SFX, speech/music when requested). Integrate sounds chronologically alongside actions. Be specific (e.g., "soft footsteps on tile"), not vague (e.g., "ambient sound is present").
- Speech (only when requested):
    - For ANY speech-related input (talking, conversation, singing, etc.), ALWAYS include exact words in quotes with voice characteristics (e.g., "The man says in an excited voice: 'You won't believe what I just saw!'").
    - Specify language if not English and accent if relevant.
- Style: Include visual style at the beginning: "Style: <style>, <rest of prompt>." Default to cinematic-realistic if unspecified. Omit if unclear.
- Visual and audio only: NO non-visual/auditory senses (smell, taste, touch).
- Restrained language: Avoid dramatic/exaggerated terms. Use mild, natural phrasing.
    - Colors: Use plain terms ("red dress"), not intensified ("vibrant blue," "bright red").
    - Lighting: Use neutral descriptions ("soft overhead light"), not harsh ("blinding light").
    - Facial features: Use delicate modifiers for subtle features (i.e., "subtle freckles").

#### Important notes:
- Analyze the user's raw input carefully. In cases of FPV or POV, exclude the description of the subject whose POV is requested.
- Camera motion: DO NOT invent camera motion unless requested by the user.
- Speech: DO NOT modify user-provided character dialogue unless it's a typo.
- No timestamps or cuts: DO NOT use timestamps or describe scene cuts unless explicitly requested.
- Format: DO NOT use phrases like "The scene opens with...". Start directly with Style (optional) and chronological scene description.
- Format: DO NOT start your response with special characters.
- DO NOT invent dialogue unless the user mentions speech/talking/singing/conversation.
- If the user's raw input prompt is highly detailed, chronological and in the requested format: DO NOT make major edits or introduce new elements. Add/enhance audio descriptions if missing.

#### Output Format (Strict):
- Single continuous paragraph in natural language (English).
- NO titles, headings, prefaces, code fences, or Markdown.
- If unsafe/invalid, return original user prompt. Never ask questions or clarifications.

Your output quality is CRITICAL. Generate visually rich, dynamic prompts with integrated audio for high-quality video generation."""

# Official Lightricks I2V system prompt (reference: LTXPipeline.swift:2817).
I2V_SYSTEM_PROMPT = """You are a Creative Assistant writing concise, action-focused image-to-video prompts. Given an image (first frame) and user Raw Input Prompt, generate a prompt to guide video generation from that image.

#### Guidelines:
- Analyze the Image: Identify Subject, Setting, Elements, Style and Mood.
- Follow user Raw Input Prompt: Include all requested motion, actions, camera movements, audio, and details. If in conflict with the image, prioritize user request while maintaining visual consistency (describe transition from image to user's scene).
- Describe only changes from the image: Don't reiterate established visual details. Inaccurate descriptions may cause scene cuts.
- Active language: Use present-progressive verbs ("is walking," "speaking"). If no action specified, describe natural movements.
- Chronological flow: Use temporal connectors ("as," "then," "while").
- Audio layer: Describe complete soundscape throughout the prompt alongside actions—NOT at the end. Align audio intensity with action tempo. Include natural background audio, ambient sounds, effects, speech or music (when requested). Be specific (e.g., "soft footsteps on tile") not vague (e.g., "ambient sound").
- Speech (only when requested): Provide exact words in quotes with character's visual/voice characteristics, language if not English and accent if relevant. If general conversation mentioned without text, generate contextual quoted dialogue.
- Style: Include visual style at beginning: "Style: <style>, <rest of prompt>." If unclear, omit to avoid conflicts.
- Visual and audio only: Describe only what is seen and heard. NO smell, taste, or tactile sensations.
- Restrained language: Avoid dramatic terms. Use mild, natural, understated phrasing.

#### Important notes:
- Camera motion: DO NOT invent camera motion/movement unless requested by the user.
- Speech: DO NOT modify or alter the user's provided character dialogue in the prompt, unless it's a typo.
- No timestamps or cuts: DO NOT use timestamps or describe scene cuts unless explicitly requested.
- Objective only: DO NOT interpret emotions or intentions - describe only observable actions and sounds.
- Format: DO NOT use phrases like "The scene opens with..." / "The video starts...". Start directly with Style (optional) and chronological scene description.
- Format: Never start output with punctuation marks or special characters.
- DO NOT invent dialogue unless the user mentions speech/talking/singing/conversation.
- Your performance is CRITICAL.

#### Output Format (Strict):
- Single concise paragraph in natural English. NO titles, headings, prefaces, sections, code fences, or Markdown.
- If unsafe/invalid, return original user prompt. Never ask questions or clarifications."""


def build_chat_prompt(system: str, user: str) -> str:
    """Gemma-3 chat template (system folded into the user turn)."""
    return (
        f"<start_of_turn>user\n{system}\n\nuser prompt: {user}<end_of_turn>\n"
        f"<start_of_turn>model\n"
    )


def clean_enhanced_prompt(text: str) -> str:
    """Strip control tokens / markdown noise
    (reference: LTXPipeline.swift:3004-3040)."""
    for tok in ("<eos>", "<end_of_turn>", "<start_of_turn>", "```"):
        text = text.replace(tok, "")
    text = text.strip()
    text = re.sub(r"^(Output|Prompt)\s*:\s*", "", text, flags=re.IGNORECASE)
    return text.strip()


def _splice_image_embeds(gemma_params, gemma_config, tokenizer, system,
                         prompt, image_embeds):
    """Splice the 256 SigLIP soft tokens at the start of the user turn
    (the reference's MLXVLM chat places the image before the text; soft
    tokens are NOT sqrt(d)-scaled, HF semantics). Returns (ids,
    input_embeds (1, T, D)) — ids are all-zero bookkeeping twins."""
    import jax.numpy as jnp
    import numpy as np

    prefix_ids = tokenizer.encode("<start_of_turn>user\n").ids
    body = (f"{system}\n\nUser Raw Input Prompt: {prompt}."
            f"<end_of_turn>\n<start_of_turn>model\n")
    body_ids = tokenizer.encode(body).ids
    edtype = gemma3.embed_dtype(gemma_params)
    scale = jnp.asarray(np.sqrt(gemma_config.hidden_size), edtype)
    pre = gemma3._embed_lookup(
        gemma_params, jnp.asarray(prefix_ids))[None] * scale
    post = gemma3._embed_lookup(
        gemma_params, jnp.asarray(body_ids))[None] * scale
    input_embeds = jnp.concatenate(
        [pre, image_embeds.astype(edtype), post], axis=1)
    return [0] * input_embeds.shape[1], input_embeds


def enhance_prompt(
    gemma_params,
    gemma_config: gemma3.Gemma3Config,
    tokenizer,
    prompt: str,
    is_i2v: bool = False,
    max_tokens: int = 512,
    temperature: float = 0.7,
    seed: int = 42,
    image_path: Optional[str] = None,
    vision_params=None,
    vision_config=None,
    spec_k: int = 8,
    spec_ngram: int = 3,
    mesh=None,
) -> str:
    """Enhance a prompt with the Gemma text model. Returns the original
    prompt unchanged if anything fails (enhancement is best-effort).

    I2V: when SigLIP vision-tower params are supplied, the conditioning
    image is embedded as soft tokens like the reference's MLXVLM path
    (LTXPipeline.swift:2862-2971); otherwise the I2V system prompt runs
    text-only with a LOUD warning (the enhanced prompt is image-blind).
    """
    system = I2V_SYSTEM_PROMPT if is_i2v else T2V_SYSTEM_PROMPT
    chat = build_chat_prompt(system, prompt)
    image_embeds = None
    if is_i2v and image_path is not None:
        if vision_params is not None:
            from ltx_jax.models import siglip

            image_embeds = siglip.embed_image_for_gemma(
                vision_params, image_path,
                vision_config or siglip.SigLIPConfig())
        else:
            log.warning(
                "I2V prompt enhancement is running TEXT-ONLY: the SigLIP "
                "vision tower is not loaded, so the enhanced prompt cannot "
                "see %s (reference feeds the image through MLXVLM, "
                "LTXPipeline.swift:2862-2971)", image_path)
    try:
        input_embeds = None
        if image_embeds is not None:
            ids, input_embeds = _splice_image_embeds(
                gemma_params, gemma_config, tokenizer, system, prompt,
                image_embeds)
        else:
            ids = tokenizer.encode(chat).ids
        stop_ids = set()
        for tok in ("<end_of_turn>", "<eos>"):
            enc = tokenizer.encode(tok).ids
            if len(enc) == 1:
                stop_ids.add(enc[0])
        stop_ids.add(1)  # Gemma <eos>
        # spec_k: prompt-lookup speculative decoding — enhancement output
        # reuses long spans of the user prompt and its own phrasing, and
        # the verify bundle rides the same weight reads as a single-token
        # step, so drafts are nearly free and the sampler distribution is
        # preserved exactly.
        tokens = gemma3.generate_tokens(
            gemma_params, [ids], gemma_config, jax.random.key(seed),
            max_new_tokens=max_tokens, temperature=temperature,
            top_p=0.95, repetition_penalty=1.1,
            stop_tokens=tuple(stop_ids), input_embeds=input_embeds,
            spec_k=spec_k, spec_ngram=spec_ngram, mesh=mesh,
        )
        text = tokenizer.decode(tokens)
        cleaned = clean_enhanced_prompt(text)
        return cleaned if cleaned else prompt
    except Exception as e:  # enhancement must never break generation
        log.warning("prompt enhancement failed (%s); using raw prompt", e)
        return prompt


def enhance_prompts(
    gemma_params,
    gemma_config: gemma3.Gemma3Config,
    tokenizer,
    prompts: List[str],
    is_i2v: bool = False,
    max_tokens: int = 512,
    temperature: float = 0.7,
    seed: int = 42,
    spec_k: int = 0,
    max_batch: int = 0,
    strict: bool = False,
    kv_quant: str = "bf16",
    mesh=None,
    image_paths: Optional[List[Optional[str]]] = None,
    vision_params=None,
    vision_config=None,
) -> List[str]:
    """Batched (text-only) enhancement for serving front-ends.

    Prompts run through ONE compiled program per micro-batch
    (gemma3.generate_tokens_batched): decode is latency-bound, so B prompts
    cost close to one — ~B× enhancement throughput. Per-prompt semantics
    match enhance_prompt's text path (same system prompt / sampler /
    stops).

    max_batch caps the rows per compiled program (0 = all at once). The
    KV cache costs ~0.5 GB/row at the 1024-slot enhancement shape
    (gemma3.enhance_row_gb); io/cli.py sizes the cap from the device's
    memory beside the resident weights. kv_quant="int8" halves the per-row
    cache: per-position int8 K/V — a small numerics change, opt-in for
    capacity.

    strict=False (the in-pipeline default) returns the raw prompts on any
    failure — enhancement must never break generation; strict=True
    re-raises so a serving front-end can distinguish "enhanced" from
    "fell back" instead of silently emitting raw prompts.
    """
    system = I2V_SYSTEM_PROMPT if is_i2v else T2V_SYSTEM_PROMPT
    if (image_paths is not None and any(p for p in image_paths)
            and vision_params is None):
        # never silently degrade image-conditioned rows to text-only:
        # strict serving callers get the error; best-effort callers get a
        # LOUD warning before the text fallback below
        msg = ("enhance_prompts got image_paths but no vision_params — "
               "the SigLIP tower is not loaded; image rows would enhance "
               "TEXT-ONLY")
        if strict:
            from ltx_jax.core.errors import InvalidConfigurationError

            raise InvalidConfigurationError(msg)
        log.warning("%s (falling back to text-only)", msg)
    try:
        input_embeds = None
        if image_paths is not None and vision_params is not None:
            # batched VLM rows: each image splices its 256 SigLIP soft
            # tokens like enhance_prompt's single-row path; None entries
            # stay text-only and mix freely in the same compiled batch
            from ltx_jax.models import siglip

            ids, input_embeds = [], []
            for p, img in zip(prompts, image_paths):
                if img is None:
                    ids.append(tokenizer.encode(
                        build_chat_prompt(system, p)).ids)
                    input_embeds.append(None)
                else:
                    emb = siglip.embed_image_for_gemma(
                        vision_params, img,
                        vision_config or siglip.SigLIPConfig())
                    i, e = _splice_image_embeds(
                        gemma_params, gemma_config, tokenizer, system, p,
                        emb)
                    ids.append(i)
                    input_embeds.append(e)
        else:
            ids = [tokenizer.encode(build_chat_prompt(system, p)).ids
                   for p in prompts]
        stop_ids = {1}
        for tok in ("<end_of_turn>", "<eos>"):
            enc = tokenizer.encode(tok).ids
            if len(enc) == 1:
                stop_ids.add(enc[0])
        step = max_batch if max_batch > 0 else len(ids)
        outs = []
        for i in range(0, len(ids), max(step, 1)):
            # fold the chunk index in: chunks must not share sample streams
            outs += gemma3.generate_tokens_batched(
                gemma_params, ids[i:i + step], gemma_config,
                jax.random.fold_in(jax.random.key(seed), i),
                max_new_tokens=max_tokens,
                temperature=temperature, top_p=0.95,
                repetition_penalty=1.1, stop_tokens=tuple(stop_ids),
                spec_k=spec_k, kv_quant=kv_quant, mesh=mesh,
            )
        return [clean_enhanced_prompt(tokenizer.decode(t)) or p
                for t, p in zip(outs, prompts)]
    except Exception as e:  # enhancement must never break generation
        if strict:
            raise
        log.warning("batched prompt enhancement failed (%s); using raw "
                    "prompts", e)
        return list(prompts)
