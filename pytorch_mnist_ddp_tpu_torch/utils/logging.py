"""The training CLIs' stdout lines, byte for byte the reference's."""

from __future__ import annotations


def train_log_line(
    epoch: int,
    samples_seen: int,
    dataset_len: int,
    batch_idx: int,
    num_batches: int,
    loss: float,
) -> str:
    """Train progress line (reference mnist.py:46-48)."""
    pct = 100.0 * batch_idx / num_batches
    return "Train Epoch: {} [{}/{} ({:.0f}%)]\tLoss: {:.6f}".format(
        epoch, samples_seen, dataset_len, pct, loss
    )


def test_summary_lines(avg_loss: float, correct: int, dataset_len: int) -> str:
    """Test summary (reference mnist.py:66-68), leading and trailing
    newline included, accuracy over the whole test set."""
    pct = 100.0 * correct / dataset_len
    return "\nTest set: Average loss: {:.4f}, Accuracy: {}/{} ({:.0f}%)\n".format(
        avg_loss, correct, dataset_len, pct
    )


def distributed_init_banner(
    rank: int, dist_url: str, local_rank: int, world_size: int
) -> str:
    """Distributed init banner (reference mnist_ddp.py:34), printed by
    every rank."""
    return (
        f"| distributed init (rank {rank}): {dist_url}, "
        f"local rank:{local_rank}, world size:{world_size}"
    )


NOT_DISTRIBUTED_NOTICE = "Not using distributed mode"


def total_time_line(elapsed_seconds: float) -> str:
    """End-of-run wall clock (reference mnist_ddp.py:203).  The label reads
    "ms" but the value is seconds, as the reference prints it."""
    return f"Total cost time:{elapsed_seconds} ms"
