"""InternVL2-26b backbone (port of ``repro.models.vlm``): an InternLM2-style
dense LM with a ViT frontend stub (the batch carries precomputed patch
embeddings ``image_embeds``). Everything else is the dense transformer; the
VLM specifics (the image embeddings prepended, so that positions and the KV
cache count them, and the text-only loss tail) live in
``transformer.embed_tokens`` and ``loss_fn`` behind ``cfg.family == "vlm"``.
The family serves and trains: the batch of a train step carries
``image_embeds`` beside its tokens (``models.stub_inputs``).
"""

from repro_torch.models.transformer import (cache_specs, decode_step, init_cache,
                                            init_params, loss_fn, param_specs,
                                            prefill)

__all__ = ["init_params", "param_specs", "loss_fn", "init_cache",
           "cache_specs", "prefill", "decode_step"]
