"""The port's kernel build plan (kernels/build.py), on the CPU: which
libraries each kernel source builds into, without compiling anything.
K5's source builds one library a residual family (``-DK5_FAMILY=f``), so
that its instances compile side by side; every other source one library."""

import pytest

from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import lm_step as k5


def test_lm_step_builds_one_library_a_family():
    libs = build.libraries("lm_step")
    assert libs == [("lm_step", k5.library(f)) for f in k5.Family]
    paths = {build._lib_path(*lib) for lib in libs}
    assert len(paths) == len(k5.Family)
    # a measurement variant's define comes first, the family's last
    assert build.libraries("lm_step", ("K5_MARKS",))[0] == \
        ("lm_step", ("K5_MARKS", "K5_FAMILY=0"))
    assert k5.library(k5.Family.ROBUST, ("K5_CLUSTER=8",)) == \
        ("K5_CLUSTER=8", "K5_FAMILY=4")


@pytest.mark.parametrize("name", sorted(set(build.kernel_names())
                                        - set(build.PARTS)))
def test_other_sources_build_one_library(name):
    assert build.libraries(name) == [(name, ())]
    assert build.libraries(name, ("X=1",)) == [(name, ("X=1",))]
