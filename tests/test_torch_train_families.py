"""``forward_train`` of the moe, vlm, audio and hybrid families against
``jax.value_and_grad`` of the reference's, at fp32 on the smoke configs
(T = 32, a multiple of the hybrid's ``ssm_chunk`` 16): the loss, ``ce``,
``aux`` and every gradient leaf, as ``_torch_lm.check_forward_train``
holds them (loss within rtol 1e-5; each gradient leaf within 1e-4 of its
largest reference value plus rtol 1e-3).

stablelm with ``attn_q_chunk`` 8: the plain route's ``chunked_sdpa`` over
query chunks, as the reference's.  mixtral: the MoE aux loss in the loss, and the router's gradient through
the kept slots' gates.  vlm: vision embeddings through the cross-attention
layers, the gates set nonzero from a numpy seed (at zero they would hide
the branch and zero its weights' gradients).  audio: frames and
``labels``, the encoder non-causal.  hybrid: jamba's attention, Mamba and
MoE layers in one period.  'cuda': the card's Functions over stand-in
kernels (the plain versions), counting the launches with remat.
"""
import pytest

from _torch_lm import check_forward_train


@pytest.mark.parametrize("arch,route", [
    ("mixtral-8x7b", "auto"), ("mixtral-8x7b", "cuda"),
    ("llama-3.2-vision-11b", "auto"), ("llama-3.2-vision-11b", "cuda"),
    ("hubert-xlarge", "auto"), ("hubert-xlarge", "cuda"),
    ("jamba-1.5-large-398b", "auto"), ("jamba-1.5-large-398b", "cuda")])
def test_forward_train_matches_value_and_grad(arch, route, monkeypatch):
    mets = check_forward_train(arch, route, monkeypatch)
    if arch in ("mixtral-8x7b", "jamba-1.5-large-398b"):
        assert mets["aux"].item() > 0.5      # E * sum f_e P_e, about 1 a layer


def test_forward_train_over_query_chunks_matches_value_and_grad(
        monkeypatch):
    check_forward_train("stablelm-3b", "reference", monkeypatch,
                        attn_q_chunk=8)
