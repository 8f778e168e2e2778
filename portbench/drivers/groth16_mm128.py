"""Groth16 sessions on the 128 x 128 matmul R1CS: the `groth16_mm64`
session, its phases and controls at the paper's top size, checked by the
cell's own reference. At this size prove's MSMs run their windows in
several chunks (`msm.windows_per_chunk`), so the cell adds the fault of a
chunk left out."""
from __future__ import annotations

import contextlib

from legosnark_tpu_torch.curve import msm as msm_mod

from portbench.drivers import groth16_mm64 as base
from portbench.reference import groth16_mm128 as ref


class Session(base.Session):
    def check(self, rec) -> list:
        if not hasattr(self, "_trapdoor"):
            self._trapdoor = ref.Trapdoor(self.n, self.setup_seed)
        st = self._st(rec.k)
        pf = rec.proof
        return ref.check(
            self._trapdoor,
            {"A": st["A"], "B": st["B"], "prove_seed": self.prove_seed(rec.k),
             "base_scalars": self.base_scalars},
            {"a": pf.a, "b": pf.b, "c": pf.c, "commit": rec.commit,
             "public": st["public"]})


@contextlib.contextmanager
def chunk_dropped():
    """Every MSM sums only the windows of its first chunk: the window sums
    of each later chunk come back as the identity."""
    calls = []

    def wrap_msm(old):
        def msm(*a, **kw):
            calls.append(0)
            return old(*a, **kw)
        return msm

    def wrap_sums(old):
        def window_sums(C, *a, **kw):
            out = old(C, *a, **kw)
            calls[-1] += 1
            if calls[-1] == 1:
                return out
            return C.identity(tuple(C.F.batch_shape(out.x)), out.x.device)
        return window_sums

    with base._patched(msm_mod, "msm", wrap_msm), \
            base._patched(msm_mod, "_window_sums", wrap_sums):
        yield


CONTROLS = base.CONTROLS
FAULTS = {**base.FAULTS, "chunk_dropped": chunk_dropped}
