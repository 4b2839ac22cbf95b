"""A cell of the benchmark cut to a size that the CPU runs in seconds."""

from pds_bench import registry


def tiny_cell(workload: str, compute_dtype: str = "float32"):
    """The workload's cell at 70x90 pairs, D=63, in ``compute_dtype``, with
    its own limits and metrics."""
    cell = registry.cell(workload)
    cell.config.update(height=70, width=90, serve_maximum_disparity=63,
                       train_maximum_disparity=63,
                       compute_dtype=compute_dtype)
    cell.config["ground_truth"] = dict(cell.config["ground_truth"],
                                       maximum=60.0)
    cell.traffic.update(shift_range=[2, 8])
    return cell
