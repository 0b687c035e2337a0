"""CLI: build a ``patient/slide`` target list from a base CSV + slide dir
(ref ``module/faster-rcnn/make_target_list.py``), ``gseg-make-target-list``.

    python -m glomeruli_segmentation_tpu_torch.cli.make_target_list \
        --base_list_csv CSV --data_dir DIR --output_file LIST

The port's own copy of ``glomeruli_segmentation_tpu/cli/make_target_list.py``;
a test holds the two equal."""
import argparse
import csv
import glob
import os


def make_list(args):
    with open(args.base_list_csv) as csv_file:
        wsi_dirs = set()
        for row in csv.reader(csv_file):
            print(row)
            wsi_dirs.add(row[3])
        print(wsi_dirs)
        with open(args.output_file, "w") as out_f:
            for wsi_dir_name in sorted(wsi_dirs):
                matches = []
                for pattern in ("*ndpi", "*.tiff", "*.tif"):
                    matches += glob.glob(os.path.join(args.data_dir,
                                                      wsi_dir_name, pattern))
                print(matches)
                assert len(matches) == 1
                name = matches[0].split("/")[-1]
                out_f.write(os.path.splitext(
                    f"{wsi_dir_name}/{name}")[0] + "\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description="MERGE_OVERLAPPED_GLOMUS")
    parser.add_argument("--base_list_csv", type=str, required=True)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--output_file", type=str, required=True)
    make_list(parser.parse_args(argv))


if __name__ == "__main__":
    main()
