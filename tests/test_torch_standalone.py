"""The port stands alone: no module of `basis_universal_tpu_torch/`, and not
`chip_smoke.py`, imports the reference package `basis_universal_tpu` (at the
top, inside a function, or to subclass it), its host modules are copies of
the reference's that say so and have not drifted, its enums agree with the
reference's member for member, and its native host library builds inside
the repository."""

import ast
import difflib
import enum
import pathlib

import pytest

from basis_universal_tpu.formats import constants as ref_constants
from basis_universal_tpu_torch import native
from basis_universal_tpu_torch.formats import constants

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "basis_universal_tpu_torch"
REF = "basis_universal_tpu"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
# copies that differ from the reference beyond their first docstring line:
# the native loader builds into the repository's build/ tree, the
# transcoder's re-encodes run on the port's device, and the XUASTC encoder
# hands `device` to the UASTC search of its 4x4 plan (and imports zstandard
# only after the FullArith syntax, which needs none, has returned, as the
# XUASTC decoder imports it only for a hybrid stream); the front doors
# (`api`, the CLI, the codec sweep and the parity harness) hand `device` to
# every encode and transcode, and the telemetry's device trace is a
# torch.profiler trace
EDITED_COPIES = {"native.py", "transcoder.py", "codecs/astc/xuastc_encode.py",
                 "codecs/astc/xuastc_ldr.py", "api.py", "cli.py",
                 "utils/telemetry.py", "testing/codec_sweep.py",
                 "testing/reference_parity.py"}


def _copies():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        if text.startswith('"""Copy of `'):
            out.append(path.relative_to(PORT).as_posix())
    return out


def _reference_names(tree, path):
    """Every way `tree` names the reference package: absolute imports,
    relative imports that climb out of the port, and the bare name (an
    attribute base such as `basis_universal_tpu.transcoder.X`)."""
    depth = len(path.relative_to(REPO).parts) - 1   # packages above the file
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names
                      if a.name.split(".")[0] == REF]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and (node.module or "").split(".")[0] == REF:
                found.append(node.module)
            elif node.level > depth:
                found.append("." * node.level + (node.module or ""))
        elif isinstance(node, ast.Name) and node.id == REF:
            found.append(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and (node.value == REF or node.value.startswith(REF + ".")):
            found.append(node.value)                # importlib by name
    return found


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_never_imports_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    assert _reference_names(tree, path) == []


def test_the_ast_walk_finds_each_kind_of_reference_import():
    src = ("import basis_universal_tpu.native\n"
           "def f():\n    from basis_universal_tpu.ops import etc1\n"
           "class T(basis_universal_tpu.transcoder.BasisTranscoder): pass\n"
           "from ... import native\n"
           "importlib.import_module('basis_universal_tpu.ops.etc1')\n")
    names = _reference_names(ast.parse(src), PORT / "ops" / "x.py")
    assert sorted(names) == ["...", "basis_universal_tpu",
                             "basis_universal_tpu.native",
                             "basis_universal_tpu.ops",
                             "basis_universal_tpu.ops.etc1"]


@pytest.mark.parametrize("rel", _copies())
def test_copies_name_their_reference_and_match_it(rel):
    text = (PORT / rel).read_text()
    first = text.splitlines()[0]
    assert first == f'"""Copy of `{REF}/{rel}`.'
    ref = (REPO / REF / rel).read_text()
    assert '"""' + text.split("\n", 2)[2] == ref or rel in EDITED_COPIES


def test_every_host_module_of_the_closure_is_copied():
    copied = set(_copies())
    for rel in ("formats/constants.py", "formats/basis_file.py",
                "formats/ktx2.py", "formats/dds.py", "utils/crc.py",
                "utils/errors.py", "entropy/bitio.py", "entropy/huffman.py",
                "entropy/arith.py", "codecs/etc1s/backend.py",
                "codecs/etc1s/stream.py", "codecs/uastc/tables.py",
                "codecs/uastc/decode.py", "codecs/uastc/astc_pack.py",
                "ops/etc1.py", "ops/resample.py", "ops/transcode.py",
                "ops/pvrtc1.py", "ops/pvrtc2.py", "ops/gpu_unpack.py",
                "ops/deblock.py", "codecs/astc/helpers.py",
                "codecs/astc/hdr_encode.py", "codecs/astc/hdr_modes.py",
                "codecs/astc/hdr6x6_decode.py", "codecs/astc/hdr6x6_tables.py",
                "codecs/astc/xuastc_ldr.py", "codecs/astc/xuastc_dct.py",
                "codecs/astc/xuastc_cems.py", "codecs/astc/xuastc_tables.py",
                "codecs/bc7/logical.py", "codecs/bc7/xbc7_decode.py",
                "codecs/bc7/xbc7_encode.py", "codecs/astc/refine.py",
                "codecs/astc/scd.py", "codecs/astc/ldr_encode.py",
                "codecs/astc/xuastc_arith_encode.py",
                "codecs/astc/xuastc_encode.py",
                "native.py", "transcoder.py", "utils/image_io.py",
                "utils/telemetry.py", "api.py", "cli.py",
                "testing/codec_sweep.py", "testing/reference_parity.py"):
        assert rel in copied, rel
    for npz in ("codecs/astc/xuastc_cfgs.npz", "codecs/astc/xuastc_idct.npz",
                "codecs/bc7/bc7_tables.npz"):
        assert (PORT / npz).read_bytes() == (REPO / REF / npz).read_bytes()


def test_the_xuastc_encoder_copy_is_edited_only_to_thread_the_device():
    rel = "codecs/astc/xuastc_encode.py"
    mine = (PORT / rel).read_text().split("\n", 2)[2].splitlines()
    theirs = (REPO / REF / rel).read_text().splitlines()
    theirs[0] = theirs[0][3:]                           # the opening quotes
    diff = [line for line in difflib.ndiff(theirs, mine)
            if line[:2] in ("- ", "+ ")]
    added = [line[2:] for line in diff if line[0] == "+"]
    assert 0 < len(diff) <= 16, diff
    assert all("device" in line or "zstandard" in line or "LogBlocks" in line
               or "_plan_4x4" in line
               or not line.strip() for line in added), added


_ENUMS = [name for name, obj in vars(constants).items()
          if isinstance(obj, type) and issubclass(obj, enum.Enum)]


@pytest.mark.parametrize("name", _ENUMS)
def test_enums_agree_with_the_reference(name):
    """Tests pass the reference's members to the port: they compare and hash
    by value, so each works wherever the port's own member does."""
    mine, theirs = getattr(constants, name), getattr(ref_constants, name)
    assert [(m.name, m.value) for m in mine] == \
        [(m.name, m.value) for m in theirs]
    lookup = {m: m.name for m in mine}
    for m in theirs:
        assert m == mine[m.name] and hash(m) == hash(mine[m.name])
        assert lookup[m] == m.name and m in tuple(mine)


def test_native_library_builds_inside_the_repository():
    assert native._CACHE_DIR == REPO / "build" / "native"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert native._SRC == REPO / "native" / "slice_codec.cpp"
    lib = native.get_lib()
    if lib is not None:                     # where a compiler is present
        assert pathlib.Path(lib._name).parent == native._CACHE_DIR


def test_host_sort_builds_inside_the_repository():
    """The port's own host source (the refine shortlist's tie order) builds
    with g++ into the same build/native/ tree, and loads."""
    assert native._SORT_SRC == PORT / "csrc" / "host_sort.cpp"
    lib = native.get_host_sort()
    assert pathlib.Path(lib._name).parent == native._CACHE_DIR
    assert pathlib.Path(lib._name).name.startswith("host_sort_")
