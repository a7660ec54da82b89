"""Architecture registry: an arch id resolves here.

The port has every arch of the reference: the decoders of kind ``lm`` (the
MoE / MLA pair granite-moe-1b-a400m and deepseek-v3-671b, and the four
dense GQA archs), the recurrent kinds ``rwkv`` (rwkv6-7b) and ``griffin``
(recurrentgemma-9b), the ``vlm`` kind (internvl2-26b) and the ``encdec``
kind (seamless-m4t-large-v2).
"""
from repro_torch.configs.deepseek_v3_671b import ARCH as deepseek_v3
from repro_torch.configs.gemma3_12b import ARCH as gemma3
from repro_torch.configs.granite_moe_1b_a400m import ARCH as granite_moe
from repro_torch.configs.internvl2_26b import ARCH as internvl2
from repro_torch.configs.llama3_2_3b import ARCH as llama32
from repro_torch.configs.recurrentgemma_9b import ARCH as recurrentgemma
from repro_torch.configs.rwkv6_7b import ARCH as rwkv6
from repro_torch.configs.seamless_m4t_large_v2 import ARCH as seamless
from repro_torch.configs.stablelm_3b import ARCH as stablelm
from repro_torch.configs.starcoder2_3b import ARCH as starcoder2

ARCHS = {a.id: a for a in [granite_moe, deepseek_v3, llama32, stablelm, gemma3,
                           starcoder2, rwkv6, recurrentgemma, internvl2, seamless]}


def get_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]
