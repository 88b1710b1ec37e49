"""The TSDF integrate's share of its roofline over the profiled slice: the
least time the chip could take for the maps published there
(`work.tsdf_work`, from the chunks, updated and carved voxels the
reference's own integrate of each map counted) over the device time of the
`tsdf_integrate` activities launched inside the `mesh` span."""

from benchmark import work


def read(run):
    tr = run.trace
    maps = run.window.slice_counters.get("maps", []) if tr is not None else []
    counted = [run.map_work[m] for m in maps if m in run.map_work]
    secs = tr.device_s({"mesh"}, name="tsdf_integrate") if counted else 0.0
    if not counted or secs <= 0:
        return None
    d, s = run.config["dense"], run.config["tsdf"]["chunk_size"]
    bound = sum(work.bound_s(*work.tsdf_work(c["chunks"], s, d["height"], d["width"],
                                             c["updated"], c["carved"]))
                for c in counted)
    return 100.0 * bound / secs
