"""Parity of the port's training losses with the JAX reference for the
non-dense kinds, on the CPU: granite-moe (routed experts, the load-balance
aux weighted 0.01), deepseek-v3 (MLA, MoE with a shared expert, the MTP
head weighted 0.3), rwkv6 and recurrentgemma (the recurrent kinds) and
internvl2 (the VLM, its loss on the text span only).

The bounds and the method are ``test_torch_lm_loss.py``'s: each arch at
``make_smoke()`` with f32 compute, the reference's parameters, one numpy
batch; the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
max |grad| (measured: losses within 8.7e-8 relative, grads within 4.4e-6
of the scale, rwkv6's the largest).  At f32 no token's top-k routing sits on a tie
here: a flip would move the loss far past 1e-5, and the check would fail
at the MoE arch.
"""

import pytest

from test_torch_lm_loss import check_loss_parity

KIND_ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b", "rwkv6-7b",
              "recurrentgemma-9b", "internvl2-26b")


@pytest.mark.parametrize("arch_id", KIND_ARCHS)
def test_kind_loss_and_grads_match_reference(arch_id):
    check_loss_parity(arch_id, seed=20 + KIND_ARCHS.index(arch_id))
