"""A cell cut to a size that a CPU test can hold: images and cameras at a
quarter of their size, 32 depths, a 10^4-word tree, a short session."""


def patch(config: dict, traffic: dict) -> None:
    c = config["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        c[k] *= 0.25
    c["width"], c["height"] = c["width"] // 4, c["height"] // 4
    config["dense"].update(height=c["height"], width=c["width"], num_depths=32,
                           dep_sample=1.0 / (0.11 * c["fx"]))
    config["vocabulary"]["levels"] = 4
    config["server"]["async_optimize"] = False
    traffic.update(warmup_keyframes=60, session_keyframes=400 if traffic["images"] else 800, check_cycles=1, landmarks=600,
                   steps_per_sweep=12)
