"""Share of the HBM roofline of the local join's pair sort
(``ops.sort_kv`` of the routed T fragments' keys and row ids): keys and
row ids in, sorted keys and permuted row ids out (real tuples only, not
the masked slots) at 3.35 TB/s over the device time of every kernel,
copy and memset the entry launched."""
from portbench.roofline import pair_sort_bytes, roofline_pct, row_bytes, \
    valid_count

UNIT = "%"
ENTRY = "repro_torch.kernels.ops:sort_kv"


def bytes_of(args, kwargs):
    keys, values = args[0], args[1]
    return valid_count(keys), pair_sort_bytes(1, keys.element_size(),
                                              row_bytes(values, keys.dim()))


def read(run):
    if run.op != "join" or run.trace is None:
        return None
    return roofline_pct(run.entry_bytes.get("pair_sort_roofline.join"),
                        run.trace.entry_device_s.get(ENTRY))
