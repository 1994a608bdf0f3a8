"""Share of the HBM roofline of the local sort of the records
(``ops.sort_kv``: keys and their payload rows, the radix family at
these widths): its bytes (keys and value rows in, sorted keys and
permuted rows out, valid entries only) at 3.35 TB/s over the device time
of every kernel, copy and memset the entry launched.  SMMS calls it in
Round 1, Terasort inside Round 3's ``sort_partition_kv``."""
from portbench.roofline import pair_sort_bytes, roofline_pct, row_bytes, \
    valid_count

UNIT = "%"
ENTRY = "repro_torch.kernels.ops:sort_kv"


def bytes_of(args, kwargs):
    keys, values = args[0], args[1]
    return valid_count(keys), pair_sort_bytes(1, keys.element_size(),
                                              row_bytes(values, keys.dim()))


def read(run):
    if run.op != "sort" or run.trace is None:
        return None
    return roofline_pct(run.entry_bytes.get("radix_sort_roofline.sort"),
                        run.trace.entry_device_s.get(ENTRY))
