"""Guards of the port's boundaries: no JAX imports, CUDA by default, and
kernel wrappers that take their plain version only for CPU tensors and
count only real launches."""
import ast
import inspect
import pathlib

import pytest
import torch

import legosnark_tpu_torch
from legosnark_tpu_torch import bench, config, kernels
from legosnark_tpu_torch import bench_gadgets
from legosnark_tpu_torch.curve import bn254, cuda_group
from legosnark_tpu_torch.curve import group as tg
from legosnark_tpu_torch.examples import cplink
from legosnark_tpu_torch.examples import hadamard as hadamard_example
from legosnark_tpu_torch.examples import legogrothmatrix, matrixac, matrixsc
from legosnark_tpu_torch.fields import cuda_limb
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.parallel import dryrun, launch, sharded  # noqa: F401
from legosnark_tpu_torch.gadgets import (  # noqa: F401
    arithcirc, groth16, hadamard, lipmaa, matrix, poly, snark, subspace)
from legosnark_tpu_torch.prototools import commit, ntt  # noqa: F401
from legosnark_tpu_torch.prototools import polytools
from legosnark_tpu_torch.probes import mont_variants
from legosnark_tpu_torch.utils import (benchmark, bp_circuits,  # noqa: F401
                                       dbg, rand, sparse, transcript, util)

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

PKG = pathlib.Path(legosnark_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "legosnark_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    # exact package match: legosnark_tpu_torch shares a prefix with
    # legosnark_tpu and is allowed
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [
        PKG.parent / "chip_smoke.py",
        PKG.parent / "scripts" / "profile_cpmmp_torch.py",
        PKG.parent / "scripts" / "sweep_g1_threads.py",
        PKG.parent / "scripts" / "time_verify_torch.py"]
    assert len(files) > 15
    assert PKG / "parallel" / "sharded.py" in files
    assert {PKG / "bench.py", PKG / "bench_gadgets.py"} <= set(files)
    bad = []
    for f in files:
        for name in _imported_modules(ast.parse(f.read_text())):
            if _forbidden(name):
                bad.append(f"{f.relative_to(PKG.parent)}: {name}")
    assert not bad, bad
    assert not _forbidden("legosnark_tpu_torch")
    assert _forbidden("legosnark_tpu") and _forbidden("legosnark_tpu.fields")
    assert _forbidden("jax.numpy")


@pytest.mark.parametrize("fn", [matrix.keygen, poly.keygen, matrix.make_nonces,
                                matrixsc.run, rand.rand_fr_mont,
                                tg.g1_generator, tg.g2_generator,
                                matrix.keygen_cached, poly.keygen_cached,
                                transcript.Transcript, mont_variants.measure,
                                hadamard.keygen, hadamard.keygen_cached,
                                hadamard.make_nonces, lipmaa.keygen,
                                lipmaa.keygen_cached, hadamard_example.run,
                                rand.rand_fr_canonical, commit.keygen,
                                sparse.insert_as_col_major, arithcirc.keygen,
                                cplink.run, matrixac.run,
                                legogrothmatrix.run, groth16.setup,
                                rand.rand_fr_mont_fast, util.load_from_file,
                                util.populate_from_file_dist,
                                util.load_point_batch, polytools.zero,
                                polytools.one, polytools.x,
                                polytools.one_minus_x, bench.run_msm,
                                bench_gadgets.bench_cplink,
                                bench_gadgets.bench_cppoly,
                                bench_gadgets.bench_cpsc,
                                bench_gadgets.bench_cphad,
                                bench_gadgets.bench_cpmmp])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default is None
    assert config.resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            config.resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*([2] * _n_required(fn)))
    else:
        assert config.resolve_device(None).type == "cuda"


def test_dryrun_cli_runs_on_the_card_unless_told_cpu():
    """Without --cpu the dry run takes NCCL over W cards; with no card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["2"])


def _n_required(fn):
    return sum(1 for p in inspect.signature(fn).parameters.values()
               if p.default is inspect.Parameter.empty)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    kernels.reset_launches()
    a = fl.tensor(fl.ints_to_limbs([3, 5, bn254.R - 1]), "cpu")
    assert torch.equal(cuda_limb.mont_mul(bn254.FR, a, a),
                       cuda_limb.mont_mul_plain(bn254.FR, a, a))
    P = tg.g1_generator((2,), "cpu")
    p = tuple(t.contiguous() for t in P)
    for got, want in zip(cuda_group.add_points(p, p),
                         cuda_group.add_points_plain(p, p)):
        assert torch.equal(got, want)
    for got, want in zip(cuda_group.double_point(p),
                         cuda_group.double_point_plain(p)):
        assert torch.equal(got, want)
    tg.G1.scalar_mul(tg.g1_generator((), "cpu"), a[:, :1])
    assert sum(kernels.launches.values()) == 0


def test_other_devices_raise_instead_of_falling_back():
    a = torch.empty((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_limb.mont_mul(bn254.FR, a, a)
    with pytest.raises(ValueError, match="device"):
        cuda_group.add_points((a, a, a), (a, a, a))
    for fn in (mont_variants.mont_mul_sos, mont_variants.mont_mul_tc):
        with pytest.raises(ValueError, match="device"):
            fn(bn254.FR, a, a)
    with pytest.raises(ValueError, match="device"):
        mont_variants.limb_product(a, a, "operand")


def test_kernel_sources_and_build_setup():
    """Every kernel source in kernels.SOURCES exists, targets sm_90a,
    and says which TPU kernel it replaces."""
    assert "-gencode=arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    for name in kernels.SOURCES:
        text = (kernels.CSRC / name).read_text()
        assert "Replaces the Pallas kernel" in text
        assert "What bounds it" in text
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "kernels")
    gitignore = (PKG.parent / ".gitignore").read_text().split()
    assert "build/" in gitignore
