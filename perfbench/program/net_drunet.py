"""The port's DRUNet, loaded with the benchmark's weights."""


def build(cfg, channels, state, device):
    from deepinv_tpu_torch.models import DRUNet, autocast

    net = DRUNet(in_channels=channels, out_channels=channels, nc=cfg["nc"], nb=cfg["nb"],
                 act_mode=cfg["act_mode"], fused=cfg["program"]["fused"], device=device)
    net.load_state_dict(state)
    return autocast(net)
