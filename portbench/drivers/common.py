"""What the drivers share: the program's models from a configuration and the
generated weights, synthetic clips, and the prompts' token ids."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from portbench import weights as PW

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: dict, device) -> torch.dtype:
    """The configuration's dtype on the card; the CPU's rehearsals run float32."""
    return DTYPES[cfg["dtype"]] if torch.device(device).type == "cuda" else torch.float32


def build_program(cfg: dict, seed: int, device, parts=("unet", "vae", "text_encoder")) -> SimpleNamespace:
    """The program's modules, built without storage and given the weights
    `weights.make` draws from the seed."""
    from fatezero_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from fatezero_tpu_torch.models.tokenizer import StubTokenizer
    from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
    from fatezero_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from fatezero_tpu_torch.ops import schedule as S

    dtype = dtype_of(cfg, device)
    u, v, t = cfg["unet"], cfg["vae"], cfg["text_encoder"]
    ctors = {
        "unet": lambda: UNetPseudo3DConditionModel(
            UNet3DConfig.from_reference({**u, **cfg.get("model_config", {})}), dtype=dtype, device="meta"),
        "vae": lambda: AutoencoderKL(VAEConfig(
            in_channels=v["in_channels"], out_channels=v["out_channels"], latent_channels=v["latent_channels"],
            block_out_channels=tuple(v["block_out_channels"]), layers_per_block=v["layers_per_block"],
            norm_num_groups=v["norm_num_groups"], scaling_factor=v["scaling_factor"]), dtype=dtype, device="meta"),
        "text_encoder": lambda: CLIPTextModel(CLIPTextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"], intermediate_size=t["intermediate_size"],
            num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
            max_position_embeddings=t["max_position_embeddings"], layer_norm_eps=t["layer_norm_eps"]),
            dtype=dtype, device="meta"),
    }
    out = SimpleNamespace(dtype=dtype, tokenizer=StubTokenizer(vocab_size=t["vocab_size"]),
                          schedule=S.make_schedule(device=device))
    for part in parts:
        module = ctors[part]()
        PW.load_into(module, PW.make(cfg, part, seed, device, dtype))
        setattr(out, part, module.eval())
    return out


def reference_weights(cfg: dict, seed: int, device, parts=("unet", "vae", "text_encoder")) -> Dict[str, Dict]:
    """The same weights again, in float32, for the reference."""
    dtype = dtype_of(cfg, device)
    return {p: {k: w.float() for k, w in PW.make(cfg, p, seed, device, dtype).items()} for p in parts}


def clip(seed: int, index: int, frames: int, res: int, device) -> torch.Tensor:
    """A synthetic clip [frames, res, res, 3] in [-1, 1]: smooth random colour
    fields that drift from frame to frame, drawn on the device."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 17 * (index + 2)) % (2 ** 63))
    side = max(res // 32, 2)
    base = torch.randn(1, 3, side, side, generator=g, device=device)
    drift = torch.randn(frames, 3, side, side, generator=g, device=device).mul_(0.15).cumsum(0)
    x = torch.nn.functional.interpolate(base + drift, size=(res, res), mode="bilinear", align_corners=False)
    return torch.tanh(x).permute(0, 2, 3, 1).contiguous()


def token_ids(tokenizer, prompts: List[str]) -> Dict:
    """What both sides read of the prompts: each prompt's padded ids with the
    empty prompt's ([2, 77]), its ids with bos and eos, and each word's token
    positions (bos counted)."""
    padded = [np.asarray(tokenizer(["", p]).input_ids) for p in prompts]
    ids = [list(tokenizer.encode(p)) for p in prompts]
    spans = []
    for p in prompts:
        pos, out = 1, []
        for word in p.split(" "):
            n = len(tokenizer.tokenize_ids(word))
            out.append(list(range(pos, pos + n)))
            pos += n
        spans.append(out)
    return {"padded": padded, "ids": ids, "spans": spans}


def k1_launches() -> int:
    """The program's count of K1 (flash forward) launches."""
    from fatezero_tpu_torch.ops import flash_attention as FA

    return FA.flash_forward.launches
