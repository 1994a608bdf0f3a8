"""Share of the HBM roofline of Round 3's merge of the landed rows
(``fused.rank_merge``, today ``merge_ranks.cu``): keys in, merged keys
and the int32 order out (valid entries only, not the tiles' pad slots)
at 3.35 TB/s over the device time of every kernel, copy and memset the
entry launched."""
from portbench.roofline import merge_bytes, roofline_pct, valid_count

UNIT = "%"
ENTRY = "repro_torch.kernels.fused:rank_merge"


def bytes_of(args, kwargs):
    keys = args[0]
    return valid_count(keys), merge_bytes(1, keys.element_size())


def read(run):
    if run.op != "sort" or run.trace is None:
        return None
    return roofline_pct(run.entry_bytes.get("merge_roofline.sort"),
                        run.trace.entry_device_s.get(ENTRY))
