"""Models of the port."""

from .cnn import CNN
from .convert import (load_flax_cache, load_flax_params, load_flax_variables,
                      to_flax_cache, to_flax_params, to_flax_variables)
from .deq import DEQ, fixed_point_solve
from .generate import beam_search, generate, prefill_cache, prefill_kv
from .hf_gpt2 import lm_from_gpt2
from .mlp import MLP
from .moe import (MoEEncoder, MoEEncoderBlock, MoEMLP, MoETransformerLM,
                  collect_moe_losses, expert_parallel_rules)
from .resnet import ResNet, ResNet18, ResNet34, ResNet50, ResNet101
from .transformer import EncoderBlock, TransformerEncoder, TransformerLM
from .unet import UNet, cosine_beta_schedule, ddim_sample, ddpm_loss
from .vit import ViT

__all__ = ["CNN", "DEQ", "EncoderBlock", "MLP", "MoEEncoder", "MoEEncoderBlock",
           "MoEMLP", "MoETransformerLM", "ResNet", "ResNet101", "ResNet18",
           "ResNet34", "ResNet50", "TransformerEncoder", "TransformerLM", "UNet",
           "ViT", "beam_search", "cosine_beta_schedule", "ddim_sample", "ddpm_loss",
           "collect_moe_losses", "expert_parallel_rules", "fixed_point_solve", "generate", "lm_from_gpt2", "load_flax_cache",
           "load_flax_params", "load_flax_variables",
           "prefill_cache", "prefill_kv", "to_flax_cache", "to_flax_params",
           "to_flax_variables"]
