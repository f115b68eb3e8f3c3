"""What the benchmark takes from the measured program,
``double_yolo_kaist_torch``: its compiled graph of a cfg, and the seeded
weights of :mod:`perfbench.weights` put into its variable tree. The
drivers import the program's entry points themselves.
"""

from __future__ import annotations


def compile_ir(cfg: dict):
    from double_yolo_kaist_torch.config.ir import compile_cfg
    return compile_cfg(cfg["cfg_path"], yolo_strides=list(cfg["yolo_strides"]),
                       bf_type=cfg["bf_type"])


def variables(model, W: dict) -> dict:
    """The program's ``{"params", "state"}`` (``graph.init``'s tree) of
    the seeded weights ``W``. The tensors are shared, not copied."""
    params, state = {}, {}

    def conv(p):
        if "b" in p:
            return {"w": p["w"], "b": p["b"]}, None
        return ({"w": p["w"], "bn": {"scale": p["scale"], "bias": p["bias"]}},
                {"mean": p["mean"], "var": p["var"]})

    for L in model.layers:
        key = f"l{L.i}"
        p = W.get(L.i)
        if L.kind == "conv":
            params[key], s = conv(p)
            if s is not None:
                state[key] = s
        elif L.kind == "dwconv":
            (dw, sdw), (pw, spw) = conv(p["dw"]), conv(p["pw"])
            params[key] = {"dw": dw, "pw": pw}
            state[key] = {"dw": sdw, "pw": spw}
        elif L.kind == "se":
            params[key] = {
                "fc1": {"w": p["w1"][:, :, None, None], "b": p["b1"]},
                "fc2": {"w": p["w2"][:, :, None, None], "b": p["b2"]}}
        elif L.kind == "shortcut" and L.weighted:
            params[key] = {"w": p["w"]}
    return {"params": params, "state": state}

