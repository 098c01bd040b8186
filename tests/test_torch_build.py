"""The plan of the port's CUDA build (``repro_torch.kernels.build``), on
the CPU: no nvcc is needed to check which libraries the sources build
into, with which flags, in which order, and which library each launch's
instance is loaded from.  The build itself, and the instances each
library holds, are checked on the card (``chip_smoke.py`` phase 2 and
``ptxas_diff.py``)."""
import collections

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa

NAMES = build.library_names()
BF16, F32 = torch.bfloat16, torch.float32


def test_library_names_list_every_part():
    stems = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert len(NAMES) == len(set(NAMES)) == 16
    assert set(stems) <= set(NAMES)
    for stem in build.PADDED_SOURCES:
        assert {stem + build.PADDED, stem + build.WIDE} <= set(NAMES)
    assert "paged_prefill" + build.INT8_POOLS in NAMES
    assert build._source("paged_prefill" + build.INT8_POOLS) == (
        build.CSRC / "paged_prefill.cu", ("-DREPRO_INT8_POOLS=1",))


def test_each_library_has_its_own_flags_and_hash():
    by_source = collections.defaultdict(list)
    for name in NAMES:
        source, flags = build._source(name)
        assert source.exists(), name
        by_source[source].append(flags)
        # every macro a flag sets is read by the source or a header
        text = source.read_text() + "".join(
            h.read_text() for h in build.CSRC.glob("*.cuh"))
        for flag in flags:
            assert flag.startswith("-D") and flag[2:].split("=")[0] in text
    for source, flags in by_source.items():
        assert len(set(flags)) == len(flags), source
    paths = [build.library_path(name) for name in NAMES]
    assert len({p.name.rsplit("-", 1)[1] for p in paths}) == len(NAMES)
    assert all(p.parent == build.BUILD_DIR for p in paths)


def test_build_order_starts_the_slowest_first():
    order = build.build_order(NAMES)
    assert sorted(order) == sorted(NAMES)
    # every library has its place in the measured order
    assert set(build.SLOWEST_FIRST) == set(NAMES)
    assert order == list(build.SLOWEST_FIRST)
    assert build.build_order(["zz_new", "matmul", "aa_new"]) == [
        "matmul", "aa_new", "zz_new"]


def test_build_all_builds_nothing_that_exists(monkeypatch, tmp_path):
    """Libraries already built are reused without nvcc (none here)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    for name in NAMES:
        build.library_path(name).touch()
    assert build.build_all() == {n: build.library_path(n) for n in NAMES}


PREFILL_NAMES = ("flash_paged_prefill", "flash_paged_prefill_quant",
                 "paged_prefill_split", "paged_prefill_split_quant")


def test_every_prefill_instance_maps_to_one_library():
    """Every bf16 prefill instance a route can ask for (every head dim to
    512, group sizes 1-9 and 12, bf16 and int8 pools) loads one library of
    the build: the own ones over bf16 pools ``paged_prefill``, over int8
    pools ``paged_prefill_int8``, the padded and wide ones their part, and
    no instance from two libraries."""
    libraries = collections.defaultdict(set)
    for name in PREFILL_NAMES:
        quant = name.endswith("_quant")
        for d in range(1, fa.MAX_HEAD_DIM + 1):
            for g in (*range(1, 10), 12):
                rt = pa.prefill_route(name, BF16, d, g)
                lib = "paged_prefill" + pa.prefill_part(rt.dp, quant)
                assert lib in NAMES
                libraries[(rt.width, rt.padded, quant)].add(lib)
    assert all(len(libs) == 1 for libs in libraries.values())
    for (width, padded, quant), (lib,) in libraries.items():
        if padded:
            assert lib == "paged_prefill" + fa.part(width)
        else:
            assert width in fa.PAGED_HEAD_DIMS
            assert lib == "paged_prefill" + (build.INT8_POOLS if quant
                                             else "")
    own = {lib for (w, padded, q), (lib,) in libraries.items() if not padded}
    assert own == {"paged_prefill", "paged_prefill" + build.INT8_POOLS}


@pytest.mark.parametrize("kind", pa.TC_KINDS)
def test_instance_info_reads_the_library_of_its_pools(kind):
    """``tc_info`` asks the library that holds the instance of its kind."""
    quant = kind.startswith("int8")
    assert pa.prefill_part(0, quant) == (build.INT8_POOLS if quant else "")
    for dp in fa.PADDED_HEAD_DIMS:
        assert pa.prefill_part(dp, quant) == fa.part(dp)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "flash_paged_decode"])
def test_every_other_route_names_a_part_of_the_build(name, dtype):
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        rt = fa.route(name, dtype, d)
        assert rt.library in build.PARTS
        assert rt.library == ("" if not rt.padded else
                              build.WIDE if rt.wide else build.PADDED)
