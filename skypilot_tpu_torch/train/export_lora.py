"""Merge trained LoRA adapters into a base checkpoint and write it as an
HF checkpoint (counterpart of skypilot_tpu/train/export_lora.py):

    python -m skypilot_tpu_torch.train.sft --model llama3-8b \\
        --base-checkpoint /ckpts/llama3-8b --lora-rank 16 \\
        --checkpoint-dir /ckpts/lora-run ...
    python -m skypilot_tpu_torch.train.export_lora \\
        --base /ckpts/llama3-8b --adapter /ckpts/lora-run \\
        --out /ckpts/llama3-8b-merged --lora-rank 16
    python -m skypilot_tpu_torch.infer.server \\
        --checkpoint /ckpts/llama3-8b-merged

--adapter is the sft run's checkpoint dir (its latest step is read,
infer/lora.py load_adapter_dir); --lora-rank and --lora-alpha must be
the training run's. The base (llama-family or mixtral / qwen3_moe,
models/weights.py load_checkpoint) loads once in its f32 masters on
--device (default 'cuda'; 'cpu' when named), and each adapted
projection merges in place, W += alpha / rank * (A @ B)^T, as the
reference's merge_lora: the peak is the base plus one projection's
delta. The merged weights are written by save_hf_checkpoint (or
save_hf_mixtral_checkpoint), in f32.
"""
import argparse

import torch


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--base', required=True,
                        help='HF-format base checkpoint dir '
                             '(llama family or mixtral)')
    parser.add_argument('--adapter', required=True,
                        help='checkpoint dir of the sft --lora-rank run')
    parser.add_argument('--out', required=True,
                        help='output HF-format checkpoint dir')
    parser.add_argument('--lora-rank', type=int, default=16)
    parser.add_argument('--lora-alpha', type=float, default=16.0)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from skypilot_tpu_torch.infer import lora as lora_lib
    from skypilot_tpu_torch.models import weights
    from skypilot_tpu_torch.utils import device as device_lib
    from skypilot_tpu_torch.utils import log_utils

    logger = log_utils.init_logger(__name__)
    try:
        tree = lora_lib.load_adapter_dir(args.adapter)
    except FileNotFoundError:
        raise SystemExit(f'no checkpoint found under {args.adapter}') \
            from None
    except ValueError as e:
        raise SystemExit(f'--adapter {args.adapter}: {e}') from None
    # The alpha / rank scaling is only right for the training rank.
    got_rank = lora_lib.adapter_rank(tree)
    if got_rank != args.lora_rank:
        raise SystemExit(
            f'adapter in {args.adapter} has rank {got_rank}, but '
            f'--lora-rank is {args.lora_rank}; the merge scaling '
            f'(alpha/rank) would be wrong — pass the training rank.')
    dev = device_lib.resolve_device(args.device)
    cfg, moe_cfg, model = weights.load_checkpoint(args.base, device=dev,
                                                  remat=False)
    scaling = args.lora_alpha / args.lora_rank
    n = merge_into(model, lora_lib.module_adapter(tree), scaling)
    if moe_cfg is not None:
        weights.save_hf_mixtral_checkpoint(cfg, moe_cfg, model, args.out)
    else:
        weights.save_hf_checkpoint(cfg, model, args.out)
    logger.info('merged adapter (rank %d, alpha %g, %d projections) into '
                '%s -> %s', args.lora_rank, args.lora_alpha, n, args.base,
                args.out)


@torch.no_grad()
def merge_into(model: torch.nn.Module, adapter, scaling: float) -> int:
    """W += scaling * (A @ B)^T in place, in W's dtype, for each
    {module path: (A [in, r], B [r, out])} of `adapter`; a path the
    model lacks, or of other widths, exits. Returns the projections
    merged."""
    for path, (a, b) in adapter.items():
        try:
            lin = model.get_submodule(path)
        except AttributeError:
            lin = None
        w = getattr(lin, 'weight', None)
        if not isinstance(lin, torch.nn.Linear) or \
                tuple(w.shape) != (b.shape[-1], a.shape[0]):
            raise SystemExit(f'adapter projection {path} ({a.shape[0]} -> '
                             f'{b.shape[-1]}) has no counterpart in the '
                             'base model: another model\'s adapter?')
        a = torch.as_tensor(a).to(device=w.device, dtype=w.dtype)
        b = torch.as_tensor(b).to(device=w.device, dtype=w.dtype)
        w.add_((scaling * (a @ b)).t())
    return len(adapter)


if __name__ == '__main__':
    main()
