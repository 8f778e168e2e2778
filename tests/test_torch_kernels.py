"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA card: each test takes the `cuda` fixture, which skips on a
machine without one. This file imports nothing of JAX, so it also runs
where JAX is missing:
    python -m pytest tests/test_torch_kernels.py --noconftest -m requires_cuda
"""
import pytest
import torch

from legosnark_tpu_torch import kernels
from legosnark_tpu_torch.curve import bn254, cuda_group, msm
from legosnark_tpu_torch.curve import group as tg
from legosnark_tpu_torch.fields import cuda_limb
from legosnark_tpu_torch.fields import limb as fl

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(gen, n, bound):
    return [int.from_bytes(torch.randint(0, 256, (40,), generator=gen,
                                         dtype=torch.uint8).numpy().tobytes(),
                           "little") % bound for _ in range(n)]


@pytest.mark.parametrize("spec", [bn254.FR, bn254.FQ], ids=["Fr", "Fq"])
def test_k1_equals_plain(cuda, spec):
    gen = torch.Generator().manual_seed(1)
    p = spec.p
    xs = [0, 1, p - 1, p, 2 * p - 1, (1 << 224) - 1] + _rand(gen, 1500, 2 * p)
    ys = [2 * p - 1] * 6 + _rand(gen, 1500, 2 * p)
    a = fl.tensor(fl.ints_to_limbs(xs), cuda).view(8, 2, -1).transpose(0, 1)
    b = fl.tensor(fl.ints_to_limbs(ys), cuda).view(8, 2, -1).transpose(0, 1)
    kernels.reset_launches()
    got = cuda_limb.mont_mul(spec, a, b)
    torch.cuda.synchronize()
    assert kernels.launches["mont_mul"] == 1
    assert torch.equal(got, cuda_limb.mont_mul_plain(spec, a, b))
    # an [8, 1] operand broadcast against [8, n]
    got = cuda_limb.mont_mul(spec, a[0], a[0][:, :1])
    assert torch.equal(got, cuda_limb.mont_mul_plain(spec, a[0], a[0][:, :1]))


def test_k2_k3_equal_plain(cuda):
    n = 1000
    table = msm.fixed_base_table(tg.G1, tg.g1_generator((), cuda), c=8)
    ks = fl.tensor(fl.ints_to_limbs(range(1, n + 1)), cuda)
    P = msm.batch_scalar_mul(tg.G1, table, ks, c=8)
    sel = torch.arange(n, device=cuda) % 4
    Q = tg.Point(*(t.roll(1, -1) for t in P))
    Q = tg.G1.select(sel == 0, P, Q)
    Q = tg.G1.select(sel == 1, tg.G1.neg(P), Q)
    Q = tg.G1.select(sel == 2, tg.G1.identity((n,), cuda), Q)
    p = tuple(t.contiguous() for t in P)
    q = tuple(t.contiguous() for t in Q)
    kernels.reset_launches()
    s = cuda_group.add_points(p, q)
    d = cuda_group.double_point(p)
    torch.cuda.synchronize()
    assert kernels.launches["g1_add"] == 1
    assert kernels.launches["g1_double"] == 1
    for got, want in zip(s, cuda_group.add_points_plain(p, q)):
        assert torch.equal(got, want)
    for got, want in zip(d, cuda_group.double_point_plain(p)):
        assert torch.equal(got, want)
    assert tg.g1_to_ints(tg.Point(*(t[:, 1:2] for t in s))) == [None]
