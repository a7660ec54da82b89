"""Architecture registry: an arch id resolves here.

The port has the reference's decoders of kind ``lm``: the MoE / MLA pair
(granite-moe-1b-a400m, deepseek-v3-671b) and the four dense GQA archs.  The
reference's other ids need modules that are not ported yet; ``get_arch``
names the ROADMAP Queue 1 item for each.
"""
from repro_torch.configs.deepseek_v3_671b import ARCH as deepseek_v3
from repro_torch.configs.gemma3_12b import ARCH as gemma3
from repro_torch.configs.granite_moe_1b_a400m import ARCH as granite_moe
from repro_torch.configs.llama3_2_3b import ARCH as llama32
from repro_torch.configs.stablelm_3b import ARCH as stablelm
from repro_torch.configs.starcoder2_3b import ARCH as starcoder2

ARCHS = {a.id: a for a in [granite_moe, deepseek_v3, llama32, stablelm, gemma3,
                           starcoder2]}

#: The reference's arch ids that the port lacks, and what each needs.
NOT_PORTED = {
    "rwkv6-7b": "nn/ssm.py and models/rwkv6.py",
    "recurrentgemma-9b": "nn/ssm.py and models/griffin.py",
    "internvl2-26b": "models/vlm.py",
    "seamless-m4t-large-v2": "models/encdec.py",
}


def get_arch(arch_id: str):
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} needs {NOT_PORTED[arch_id]}, not ported "
                       "yet (ROADMAP Queue 1 #4 item 3, the LM substrate)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]
