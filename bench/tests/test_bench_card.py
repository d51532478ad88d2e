"""On the card (skipped without one): the reference's exact LUT products
through int8 tensor-core matmuls, against a plain gather and against the
program's kernel; the tiny cells through the program's kernels, sound and
with the control in the program's place.

  python3 -m pytest -q -p no:cacheprovider bench/tests/test_bench_card.py
"""
import pytest
import torch

from bench import harness as H
from bench.reference import lm as REF

pytestmark = pytest.mark.card


@pytest.mark.parametrize("M,K,N", [(3, 64, 40), (20, 64, 48),
                                   (300, 256, 64)])
def test_lut_products_on_the_card(card, M, K, N):
    g = torch.Generator(device="cuda").manual_seed(M)
    a = torch.randint(256, (M, K), device="cuda", generator=g)
    b = torch.randint(256, (K, N), device="cuda", generator=g)
    t = torch.randint(65536, (256, 256), device="cuda", generator=g)
    assert (REF.lut_products(a, b, t) == t[a[:, :, None], b[None]].sum(1)
            ).all()


def test_lut_products_equal_the_programs_kernel(card):
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randint(256, (256, 3072), device="cuda", generator=g)
    b = torch.randint(256, (3072, 1024), device="cuda", generator=g)
    t = torch.randint(65536, (256, 256), device="cuda", generator=g)
    got = ops.lut_matmul(a.to(torch.uint8), b.to(torch.uint8),
                         t.to(torch.int32))
    assert (got.to(torch.int64) == REF.lut_products(a, b, t)).all()


@pytest.mark.parametrize("name", ["tiny.sweep", "tiny.eval", "tiny.decode"])
def test_tiny_cells_on_the_card(card, tiny_root, name):
    cell = H.find_cell(name, tiny_root)
    out, _ = H.driver(cell).run(cell, 31337, 0.5, False, "cuda",
                                control=True)
    assert all(c.ok for c in out.checks), out.checks
    limits = cell.params["limits"]
    assert any(v > limits[k] for k, v in out.control.items()), out.control
