"""Tensor-parallel compute of jamba's SSM layers over the mesh's "model"
axis (the reduced hybrid: 7 SSM layers and one attention layer a period,
MoE on the odd slots, expert-parallel on every mesh here), on gloo CPU
ranks against the JAX package's GSPMD runs and the port's unsharded runs:
the checks of ``tests/test_torch_tensor_parallel_mixers.py``, with its
tolerances, on (1, 2), (1, 4) and (2, 2).
"""
import pytest

import test_torch_tensor_parallel_mixers as MX

ARCHS = ("jamba_1_5_large_398b",)
CASES = [(a, s) for a in ARCHS for s in MX.SHAPES]

runs = MX.make_runs(ARCHS)


@pytest.mark.parametrize("arch,shape", CASES)
def test_forward_and_gradients_against_reference(runs, arch, shape):
    MX.check_forward_and_gradients_against_reference(runs, arch, shape)


@pytest.mark.parametrize("arch,shape", CASES)
def test_training_against_reference(runs, arch, shape):
    MX.check_training_against_reference(runs, arch, shape)


@pytest.mark.parametrize("arch,shape", CASES)
def test_decode_on_split_state(runs, arch, shape):
    MX.check_decode_on_split_state(runs, arch, shape)


@pytest.mark.parametrize("arch,shape", CASES)
def test_lut_logits_against_one_rank(runs, arch, shape):
    MX.check_lut_logits_against_one_rank(runs, arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_mixer_flops_split_over_tp(runs, arch, shape):
    MX.check_mixer_flops_split_over_tp(runs, arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_and_cross_blocks_split(runs, arch):
    MX.check_ssm_and_cross_blocks_split(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_weight_gather_in_an_ssm_or_cross_block(runs, arch):
    MX.check_no_weight_gather_in_an_ssm_or_cross_block(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_remat_and_chunked_loss(runs, arch, shape):
    MX.check_remat_and_chunked_loss(runs, arch, shape)
