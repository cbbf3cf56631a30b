"""Tiny Hugging Face checkpoint dirs of every family the HF loaders take,
for the port's checkpoint tests (tests/test_torch_hf_import.py,
tests/test_torch_gptq_export.py).

Where `transformers` has the model class, the dir is its `save_pretrained`
of a random model (every parameter redrawn from a seed, so that norms and
biases are not ones and zeros); where it has not (MPT with LayerNorm
biases, OPT under the `decoder.` prefix, `.bin` shards), the dir is written
from a key dict, as tests/test_import_variants.py does."""

import json
import os

import torch

# name: (transformers config class, model class, config kwargs)
_HF_MODELS = {
    "llama_untied": ("LlamaConfig", "LlamaForCausalLM",
                     dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          tie_word_embeddings=False)),
    "llama_tied": ("LlamaConfig", "LlamaForCausalLM",
                   dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        tie_word_embeddings=True)),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
              dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=False)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM",
              dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                   tie_word_embeddings=True)),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, pad_token_id=0,
                  bos_token_id=1, eos_token_id=2, tie_word_embeddings=False)),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                    sliding_window=8)),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM",
               dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                    sliding_window=8)),
    "falcon_mqa": ("FalconConfig", "FalconForCausalLM",
                   dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, multi_query=True, parallel_attn=True,
                        new_decoder_architecture=False, alibi=False, bias=False)),
    "falcon_rw": ("FalconConfig", "FalconForCausalLM",
                  dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, multi_query=False, parallel_attn=False,
                       new_decoder_architecture=False, alibi=True, bias=False)),
    "falcon_new": ("FalconConfig", "FalconForCausalLM",
                   dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, num_kv_heads=2, new_decoder_architecture=True,
                        parallel_attn=True, alibi=False, bias=False)),
    "mpt": ("MptConfig", "MptForCausalLM",
            dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, expansion_ratio=4,
                 max_seq_len=128)),
    "opt": ("OPTConfig", "OPTForCausalLM",
            dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, ffn_dim=128,
                 num_attention_heads=4, max_position_embeddings=64, word_embed_proj_dim=64)),
    "bloom": ("BloomConfig", "BloomForCausalLM",
              dict(vocab_size=128, hidden_size=96, n_layer=2, n_head=6)),
}

# built from another case's state dict
_DERIVED = {
    "mpt_norm_bias": "mpt",  # LayerNorm biases added (HF's MPT has none)
    "opt_decoder_prefix": "opt",  # keys under `decoder.`, not `model.decoder.`
    "llama_bin_shards": "llama_untied",  # two pytorch_model-*.bin shards, bf16
    "llama_f16": "llama_untied",  # an f16 source
}

CASES = sorted(_HF_MODELS) + sorted(_DERIVED)


def _hf_model(name: str, seed: int):
    import transformers

    cfg_cls, model_cls, kw = _HF_MODELS[name]
    cfg = getattr(transformers, cfg_cls)(**kw)
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(cfg).eval().to(torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.ndim == 1 else 0.0))
    return model


def _write(path: str, state: dict, config: dict) -> None:
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    save_file({k: v.contiguous() for k, v in state.items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)


def build(name: str, root: str, seed: int = 0) -> str:
    """The checkpoint dir of one case under `root`."""
    path = os.path.join(root, name)
    if os.path.isdir(path):
        return path
    if name in _HF_MODELS:
        _hf_model(name, seed).save_pretrained(path, safe_serialization=True)
        return path
    base = _hf_model(_DERIVED[name], seed)
    config = base.config.to_dict()
    state = {k: v.detach().clone() for k, v in base.state_dict().items()}
    if name == "mpt_norm_bias":
        g = torch.Generator().manual_seed(seed + 1)
        for k in list(state):
            if k.endswith(("norm_1.weight", "norm_2.weight", "norm_f.weight")):
                state[k[: -len("weight")] + "bias"] = torch.randn(state[k].shape, generator=g)
        state.pop("lm_head.weight", None)
        _write(path, state, config)
    elif name == "opt_decoder_prefix":
        state = {k[len("model."):]: v for k, v in state.items() if k.startswith("model.")}
        _write(path, state, config)
    elif name == "llama_f16":
        base.half().save_pretrained(path, safe_serialization=True)
    elif name == "llama_bin_shards":
        os.makedirs(path, exist_ok=True)
        names = sorted(state)
        half = len(names) // 2
        for i, part in enumerate((names[:half], names[half:])):
            torch.save({k: state[k].to(torch.bfloat16) for k in part},
                       os.path.join(path, f"pytorch_model-0000{i + 1}-of-00002.bin"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
    return path
