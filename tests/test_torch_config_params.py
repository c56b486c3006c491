"""The port's ``config.py``, ``params.py`` and ``registry.py`` against
the reference's.

The cases of the reference's ``tests/test_config.py``,
``tests/test_params.py`` and ``tests/test_registry.py`` run against both
packages (``pkg`` is ``port`` or ``reference``), with each package's own
error classes. Then the same inputs through both compare exactly: the
``to_proto_string`` text, the parsed items, the ``docstring()`` and
``save_json`` text and the error messages. The port's errors derive from
its own ``DMLCError``.
"""

import types

import pytest

from dmlc_core_tpu import base as ref_base
from dmlc_core_tpu import config as ref_config
from dmlc_core_tpu import params as ref_params
from dmlc_core_tpu import registry as ref_registry

from dmlc_core_tpu_torch import base, config, params, registry

PKGS = {
    "port": types.SimpleNamespace(Config=config.Config,
                                  ConfigError=config.ConfigError,
                                  Parameter=params.Parameter,
                                  ParamError=params.ParamError,
                                  field=params.field,
                                  Registry=registry.Registry,
                                  DMLCError=base.DMLCError),
    "reference": types.SimpleNamespace(Config=ref_config.Config,
                                       ConfigError=ref_config.ConfigError,
                                       Parameter=ref_params.Parameter,
                                       ParamError=ref_params.ParamError,
                                       field=ref_params.field,
                                       Registry=ref_registry.Registry,
                                       DMLCError=ref_base.DMLCError),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _learning_param(pkg):
    field = pkg.field

    class LearningParam(pkg.Parameter):
        float_param = field(float, default=1.5, desc="a float",
                            range=(-10.0, 10.0))
        int_param = field(int, default=3, lower_bound=0)
        name = field(str, default="hello")
        flag = field(bool, default=False)
        kind = field(str, default="a", enum=["a", "b", "c"])
    return LearningParam


def _required_param(pkg):
    class RequiredParam(pkg.Parameter):
        num_hidden = pkg.field(int, desc="no default — required")
    return RequiredParam


# -- config (reference tests/test_config.py) ---------------------------------
def test_config_basic_parse(pkg):
    cfg = pkg.Config("k1 = v1\nk2=v2\n  k3   =    v3  # trailing comment\n")
    assert [cfg.get_param(k) for k in ("k1", "k2", "k3")] == \
        ["v1", "v2", "v3"]


def test_config_quoted_strings_and_escapes(pkg):
    cfg = pkg.Config('msg = "hello world"\nesc = "say \\"hi\\""\n')
    assert cfg.get_param("msg") == "hello world"
    assert cfg.get_param("esc") == 'say "hi"'


def test_config_comments_and_blank_lines(pkg):
    cfg = pkg.Config("# full comment line\n\nk = v\n# another\n")
    assert cfg.get_param("k") == "v"
    assert list(cfg.items()) == [("k", "v")]


def test_config_single_and_multi_value(pkg):
    cfg = pkg.Config("k = a\nk = b\n", multi_value=False)
    assert cfg.get_param("k") == "b" and list(cfg.items()) == [("k", "b")]
    cfg = pkg.Config("k = a\nk = b\nj = c\n", multi_value=True)
    assert list(cfg.items()) == [("k", "a"), ("k", "b"), ("j", "c")]
    assert cfg.get_param("k") == "b"


@pytest.mark.parametrize("text,match", [
    ('k = "oops\n', "not closed"),
    ('k = "bad \\n escape"\n', "escape"),
    ("k = \n", "dangling"),
    ('k "=" v\n', "expected 'key = value'"),
])
def test_config_refusals(pkg, text, match):
    with pytest.raises(pkg.ConfigError, match=match):
        pkg.Config(text)
    assert issubclass(pkg.ConfigError, pkg.DMLCError)


def test_config_proto_string_and_set_param(pkg):
    cfg = pkg.Config()
    cfg.set_param("num_round", 10)
    cfg.set_param("name", "model", is_string=True)
    proto = cfg.to_proto_string()
    assert "num_round : 10\n" in proto and 'name : "model"\n' in proto
    cfg = pkg.Config()
    cfg.set_param("k", 1)
    cfg.set_param("k", 2)
    assert cfg.get_param("k") == "2" and len(list(cfg.items())) == 1


@pytest.mark.parametrize("multi", [False, True])
def test_config_same_text_both_packages(multi):
    text = ('# header\nalpha = 1\nname = "a \\"quoted\\" word"\n'
            'alpha=2  # again\npath = /x/y#z\nflag = "="\n')
    port = config.Config(text, multi_value=multi)
    ref = ref_config.Config(text, multi_value=multi)
    port.set_param("extra", True)
    ref.set_param("extra", True)
    assert list(port.items()) == list(ref.items())
    assert port.to_proto_string() == ref.to_proto_string()
    assert ("alpha" in port) == ("alpha" in ref) is True


# -- params (reference tests/test_params.py) ---------------------------------
def test_params_defaults_and_strings(pkg):
    p = _learning_param(pkg)()
    assert (p.float_param, p.int_param, p.name, p.flag) == \
        (1.5, 3, "hello", False)
    unknown = p.init({"float_param": "2.5", "int_param": "7",
                      "flag": "true", "unknown_key": "1"},
                     allow_unknown=True)
    assert (p.float_param, p.int_param, p.flag) == (2.5, 7, True)
    assert unknown == {"unknown_key": "1"}


@pytest.mark.parametrize("kwargs,match", [
    ({"nope": 1}, "Unknown parameter"),
    ({"float_param": 100.0}, "out of range"),
    ({"int_param": -1}, "lower bound"),
    ({"kind": "z"}, "not in allowed set"),
    ({"int_param": "abc"}, "Invalid value"),
    ({"flag": "maybe"}, "invalid boolean"),
])
def test_params_refusals(pkg, kwargs, match):
    with pytest.raises(pkg.ParamError, match=match):
        _learning_param(pkg)().init(kwargs)
    assert issubclass(pkg.ParamError, pkg.DMLCError)


def test_params_enum_required_setattr_aliases(pkg):
    p = _learning_param(pkg)()
    p.init({"kind": "b"})
    assert p.kind == "b"
    with pytest.raises(pkg.ParamError):
        p.kind = "bad"
    with pytest.raises(pkg.ParamError, match="Required parameters missing"):
        _required_param(pkg)().init({})
    q = _required_param(pkg)()
    q.init({"num_hidden": 10})
    assert q.num_hidden == 10

    class AliasParam(pkg.Parameter):
        learning_rate = pkg.field(float, default=0.1, aliases=["lr", "eta"])

    a = AliasParam()
    a.init({"eta": "0.5"})
    assert a.learning_rate == 0.5


def test_params_docstring_fields_json(pkg):
    cls = _learning_param(pkg)
    doc = cls.docstring()
    assert "float_param" in doc and "a float" in doc
    assert [f.name for f in cls.fields()] == \
        ["float_param", "int_param", "name", "flag", "kind"]
    p = cls()
    p.init({"float_param": 2.0, "name": "world"})
    q = cls()
    q.load_json(p.save_json())
    assert q.as_dict() == p.as_dict()


def test_params_same_text_both_packages():
    port, ref = _learning_param(PKGS["port"]), \
        _learning_param(PKGS["reference"])
    assert port.docstring() == ref.docstring()
    a, b = port(), ref()
    kw = {"float_param": "-2.25", "int_param": "9", "flag": "on",
          "name": "x", "kind": "c", "other": "1"}
    assert a.init(dict(kw), allow_unknown=True) == \
        b.init(dict(kw), allow_unknown=True)
    assert a.save_json() == b.save_json() and repr(a).split("(")[1] == \
        repr(b).split("(")[1]
    d1, d2 = dict(kw), dict(kw)
    assert a.update_dict(d1) == b.update_dict(d2) and d1 == d2
    for bad in ({"nope": 1}, {"float_param": 10.0}, {"kind": "q"}):
        with pytest.raises(params.ParamError) as e1:
            port().init(bad)
        with pytest.raises(ref_params.ParamError) as e2:
            ref().init(bad)
        assert str(e1.value) == str(e2.value)


# -- registry (reference tests/test_registry.py) -----------------------------
def test_registry_register_find_lookup(pkg):
    reg = pkg.Registry.get("torch_parity_tree")
    reg.register("binary", lambda: "binary-tree").describe("a binary tree")
    try:
        entry = reg.find("binary")
        assert entry() == "binary-tree"
        assert entry.description == "a binary tree"
        assert reg.find("missing") is None
        with pytest.raises(pkg.DMLCError, match="unknown entry"):
            reg.lookup("missing")
    finally:
        reg.remove("binary")


def test_registry_decorator_duplicate_override(pkg):
    reg = pkg.Registry.get("torch_parity_tree2")

    @reg.register("avl")
    def make_avl():
        return "avl"

    try:
        assert reg.lookup("avl")() == "avl"
        with pytest.raises(pkg.DMLCError, match="already registered"):
            reg.register("avl", lambda: None)
        reg.register("avl", lambda: "avl2", override=True)
        assert reg.lookup("avl")() == "avl2"
        assert reg.list_names() == ["avl"]
    finally:
        reg.remove("avl")


def test_registry_singletons_and_metadata(pkg):
    assert pkg.Registry.get("kind_a") is pkg.Registry.get("kind_a")
    assert pkg.Registry.get("kind_a") is not pkg.Registry.get("kind_b")
    reg = pkg.Registry.get("torch_parity_meta")
    entry = (reg.register("e", lambda **kw: kw)
             .describe("entry with args")
             .add_argument("alpha", "float", "learning rate")
             .set_return_type("dict"))
    try:
        assert entry.arguments == [("alpha", "float", "learning rate")]
        assert entry.return_type == "dict"
        assert reg.lookup("e")(alpha=1.0) == {"alpha": 1.0}
    finally:
        reg.remove("e")


def test_registries_are_separate_per_package():
    """The port keeps registries of its own: a name registered in one
    package is not seen by the other."""
    port = registry.Registry.get("torch_parity_sep")
    ref = ref_registry.Registry.get("torch_parity_sep")
    assert port is not ref
    port.register("x", lambda: 1)
    try:
        assert ref.find("x") is None
        with pytest.raises(ref_base.DMLCError) as e_ref:
            ref.lookup("x")
        port.remove("x")
        with pytest.raises(base.DMLCError) as e_port:
            port.lookup("x")
        assert str(e_port.value) == str(e_ref.value)
    finally:
        port.remove("x")
