"""2-D stencils built with either package's eDSL (``st``), for the port's
tests: the same builder gives the reference's and the port's form of one
stencil.  No JAX here, so the card-only tests can use it too."""


def _one(st, out):
    return st.load_stencil_module({"STENCIL": [out]})[0]


def lin5(st):
    i, j = st.Index(0), st.Index(1)
    g, o = st.Grid("in", 2), st.Grid("out", 2)
    o(i, j).assign(st.ConstRef("a") * g(i, j)
                   + st.ConstRef("b") * (g(i + 1, j) + g(i - 1, j)
                                         + g(i, j + 1) + g(i, j - 1)))
    return _one(st, o)


def box9(st):
    """The 9-point box of the 2-D leg of ``bench.py``."""
    i, j = st.Index(0), st.Index(1)
    g, o = st.Grid("in", 2), st.Grid("out", 2)
    C = st.ConstRef
    o(i, j).assign(C("0.4") * g(i, j)
                   + C("0.1") * (g(i + 1, j) + g(i - 1, j)
                                 + g(i, j + 1) + g(i, j - 1))
                   + C("0.02") * (g(i + 1, j + 1) + g(i - 1, j + 1)
                                  + g(i + 1, j - 1) + g(i - 1, j - 1)))
    return _one(st, o)


def asym9(st):
    """Radius 2, asymmetric in both axes."""
    i, j = st.Index(0), st.Index(1)
    g, o = st.Grid("in", 2), st.Grid("out", 2)
    o(i, j).assign(1.0 * g(i, j) + 0.6 * g(i + 2, j)
                   - 0.3 * g(i - 1, j + 1) + 0.2 * g(i, j - 2)
                   + 0.9 * g(i + 1, j + 1) - 0.4 * g(i - 2, j - 1))
    return _one(st, o)


def nonlin(st):
    i, j = st.Index(0), st.Index(1)
    g, o = st.Grid("in", 2), st.Grid("out", 2)
    mx = st.Func("max", 2)
    o(i, j).assign(st.If(g(i, j) > 0,
                         mx(g(i + 1, j), g(i, j + 1)) * 0.5,
                         g(i - 1, j - 1)))
    return _one(st, o)


def varcoeff(st):
    """Two inputs: a field and a static coefficient field."""
    i, j = st.Index(0), st.Index(1)
    g, c, o = st.Grid("in", 2), st.Grid("c", 2), st.Grid("out", 2)
    o(i, j).assign(c(i, j) * g(i + 1, j) + c(i, j + 1) * g(i, j - 1))
    return _one(st, o)


def poly_system(st):
    """A 2-output polynomial system (Gray-Scott-like)."""
    i, j = st.Index(0), st.Index(1)
    u, v = st.Grid("u", 2), st.Grid("v", 2)
    ou, ov = st.Grid("ou", 2), st.Grid("ov", 2)
    uv = u(i, j) * v(i, j)
    ou(i, j).assign(u(i, j) + 0.1 * (u(i + 1, j) + u(i, j - 1)) - uv)
    ov(i, j).assign(v(i, j) + 0.05 * v(i, j + 1) + uv)
    return st.load_stencil_module({"STENCIL": [ou, ov]})


def wave(st):
    """The wave system of ``examples/wave_2d.py``: p' = p + v + 0.2 lap(p),
    v' = v + 0.2 lap(p)."""
    i, j = st.Index(0), st.Index(1)
    p, v = st.Grid("p", 2), st.Grid("v", 2)
    op, ov = st.Grid("op", 2), st.Grid("ov", 2)

    def lap(g):
        return (g(i + 1, j) + g(i - 1, j) + g(i, j + 1) + g(i, j - 1)
                - 4.0 * g(i, j))

    op(i, j).assign(p(i, j) + v(i, j) + 0.2 * lap(p))
    ov(i, j).assign(v(i, j) + 0.2 * lap(p))
    return st.load_stencil_module({"STENCIL": [op, ov]})


PARAMS = {"a": 0.4, "b": 0.15}
BUILDERS = {"lin5": lin5, "box9": box9, "asym9": asym9, "nonlin": nonlin,
            "varcoeff": varcoeff, "poly_system": poly_system, "wave": wave}
